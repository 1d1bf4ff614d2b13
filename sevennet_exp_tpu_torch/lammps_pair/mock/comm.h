// Mock LAMMPS Comm (see lammps.h for why this tree exists).
#ifndef LMP_COMM_H
#define LMP_COMM_H

#include "pointers.h"

namespace LAMMPS_NS {

class Comm {
 public:
  int me = 0;
  int nprocs = 1;
};

}  // namespace LAMMPS_NS

#endif
