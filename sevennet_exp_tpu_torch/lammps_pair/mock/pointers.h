// Mock LAMMPS Pointers base (see lammps.h for why this tree exists).
#ifndef LMP_POINTERS_H
#define LMP_POINTERS_H

#include "lammps.h"

#define FLERR __FILE__, __LINE__

namespace LAMMPS_NS {

typedef int tagint;

class Pointers {
 public:
  explicit Pointers(LAMMPS* ptr)
      : lmp(ptr),
        atom(ptr->atom),
        comm(ptr->comm),
        domain(ptr->domain),
        error(ptr->error),
        force(ptr->force),
        memory(ptr->memory),
        neighbor(ptr->neighbor) {}
  virtual ~Pointers() = default;

  LAMMPS* lmp;
  Atom* atom;
  Comm* comm;
  Domain* domain;
  Error* error;
  Force* force;
  Memory* memory;
  Neighbor* neighbor;
};

}  // namespace LAMMPS_NS

#endif
