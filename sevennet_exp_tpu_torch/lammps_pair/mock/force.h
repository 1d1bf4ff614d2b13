// Mock LAMMPS Force (see lammps.h for why this tree exists).
#ifndef LMP_FORCE_H
#define LMP_FORCE_H

#include "pointers.h"

namespace LAMMPS_NS {

class Force {
 public:
  double boltz = 8.617333262e-5;  // eV/K (metal units)
};

}  // namespace LAMMPS_NS

#endif
