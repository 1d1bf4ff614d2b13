// Mock LAMMPS Error (see lammps.h for why this tree exists).
#ifndef LMP_ERROR_H
#define LMP_ERROR_H

#include <cstdio>
#include <cstdlib>

#include "pointers.h"

namespace LAMMPS_NS {

class Error {
 public:
  [[noreturn]] void all(const char* file, int line, const char* msg) {
    std::fprintf(stderr, "LAMMPS error (all) %s:%d: %s\n", file, line, msg);
    std::exit(1);
  }
  [[noreturn]] void one(const char* file, int line, const char* msg) {
    std::fprintf(stderr, "LAMMPS error (one) %s:%d: %s\n", file, line, msg);
    std::exit(1);
  }
};

}  // namespace LAMMPS_NS

#endif
