// Mock LAMMPS Pair base (see lammps.h for why this tree exists).
#ifndef LMP_PAIR_H
#define LMP_PAIR_H

#include "pointers.h"

namespace LAMMPS_NS {

class Pair : protected Pointers {
 public:
  explicit Pair(LAMMPS* lmp) : Pointers(lmp) {}
  ~Pair() override = default;

  virtual void compute(int eflag, int vflag) = 0;
  virtual void settings(int narg, char** arg) = 0;
  virtual void coeff(int narg, char** arg) = 0;
  virtual void init_style() {}

  int single_enable = 1;
  int restartinfo = 1;
  int one_coeff = 0;
  int manybody_flag = 0;
  int allocated = 0;

  int** setflag = nullptr;
  double** cutsq = nullptr;
  class NeighList* list = nullptr;

  double eng_vdwl = 0.0;
  int eflag_global = 0;
  int vflag_global = 0;
  double virial[6] = {0, 0, 0, 0, 0, 0};

 protected:
  void ev_init(int eflag, int vflag) {
    eflag_global = eflag ? 1 : 0;
    vflag_global = vflag ? 1 : 0;
    eng_vdwl = 0.0;
    for (int k = 0; k < 6; ++k) virial[k] = 0.0;
  }
};

}  // namespace LAMMPS_NS

#endif
