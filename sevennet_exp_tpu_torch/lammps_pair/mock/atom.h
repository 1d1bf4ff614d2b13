// Mock LAMMPS Atom (see lammps.h for why this tree exists).
#ifndef LMP_ATOM_H
#define LMP_ATOM_H

#include <vector>

#include "pointers.h"

namespace LAMMPS_NS {

class Atom {
 public:
  enum { MAP_NONE = 0, MAP_ARRAY = 1, MAP_HASH = 2 };

  int ntypes = 0;
  int nlocal = 0;
  int nghost = 0;
  int map_style = MAP_ARRAY;

  int* type = nullptr;      // [nlocal+nghost], 1-based types
  tagint* tag = nullptr;    // [nlocal+nghost], 1-based global ids
  double** x = nullptr;     // [nlocal+nghost][3]
  double** f = nullptr;     // [nlocal+nghost][3]

  // tag -> local index (-1 if not owned); sized 1+max tag
  std::vector<int> map_store;
  int map(tagint t) const {
    return (t >= 0 && t < static_cast<int>(map_store.size()))
               ? map_store[t]
               : -1;
  }
};

}  // namespace LAMMPS_NS

#endif
