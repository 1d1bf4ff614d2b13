// Mock LAMMPS NeighList (see lammps.h for why this tree exists).
#ifndef LMP_NEIGH_LIST_H
#define LMP_NEIGH_LIST_H

#include "pointers.h"

// low bits carry the neighbor index; high bits are special-bond flags
#define NEIGHMASK 0x3FFFFFFF

namespace LAMMPS_NS {

class NeighList {
 public:
  int inum = 0;             // # of local atoms with lists
  int* ilist = nullptr;     // [inum] local indices
  int* numneigh = nullptr;  // [nlocal] neighbor counts
  int** firstneigh = nullptr;  // [nlocal] -> neighbor index arrays
};

}  // namespace LAMMPS_NS

#endif
