// Mock LAMMPS Domain (see lammps.h for why this tree exists).
#ifndef LMP_DOMAIN_H
#define LMP_DOMAIN_H

#include "pointers.h"

namespace LAMMPS_NS {

class Domain {
 public:
  double xprd = 0.0, yprd = 0.0, zprd = 0.0;  // orthorhombic box lengths
};

}  // namespace LAMMPS_NS

#endif
