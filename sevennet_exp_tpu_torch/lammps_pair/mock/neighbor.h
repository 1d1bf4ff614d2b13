// Mock LAMMPS Neighbor (see lammps.h for why this tree exists).
#ifndef LMP_NEIGHBOR_H
#define LMP_NEIGHBOR_H

#include "pointers.h"

namespace LAMMPS_NS {

namespace NeighConst {
enum { REQ_DEFAULT = 0, REQ_FULL = 1 << 0, REQ_GHOST = 1 << 1 };
}  // namespace NeighConst

class Neighbor {
 public:
  int requested_flags = -1;  // recorded for harness assertions
  void add_request(void* /*requestor*/, int flags) {
    requested_flags = flags;
  }
};

}  // namespace LAMMPS_NS

#endif
