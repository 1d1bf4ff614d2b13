// Mock LAMMPS NeighRequest (see lammps.h for why this tree exists).
#ifndef LMP_NEIGH_REQUEST_H
#define LMP_NEIGH_REQUEST_H

namespace LAMMPS_NS {
class NeighRequest {};
}  // namespace LAMMPS_NS

#endif
