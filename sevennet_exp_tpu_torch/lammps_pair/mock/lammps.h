// Minimal mock of the LAMMPS public API surface used by
// pair_sevennet_torch.cpp. Purpose: the repository ships no LAMMPS
// source tree, so without these headers the pair style could never be
// compiled or driven; with them it compiles unmodified
// (-DLAMMPS_VERSION_NUMBER -Ilammps_pair/mock) and is exercised
// end-to-end by lammps_pair/harness.cpp against libsevenn_exec
// (tests/test_torch_lammps_pair.py). The class/member names are the LAMMPS
// public interface contract (docs.lammps.org/Developer); the
// implementations here are original minimal stand-ins, not LAMMPS code.
#ifndef LMP_LAMMPS_H
#define LMP_LAMMPS_H

namespace LAMMPS_NS {

class Atom;
class Comm;
class Domain;
class Error;
class Force;
class Memory;
class Neighbor;

class LAMMPS {
 public:
  Atom* atom = nullptr;
  Comm* comm = nullptr;
  Domain* domain = nullptr;
  Error* error = nullptr;
  Force* force = nullptr;
  Memory* memory = nullptr;
  Neighbor* neighbor = nullptr;
};

}  // namespace LAMMPS_NS

#endif
