// Header of the LAMMPS pair style sevennet_torch
// (see pair_sevennet_torch.cpp for status and integration steps).
#ifdef PAIR_CLASS
// clang-format off
PairStyle(sevennet_torch, PairSevenNetTorch);
// clang-format on
#else

#ifndef LMP_PAIR_SEVENNET_TORCH_H
#define LMP_PAIR_SEVENNET_TORCH_H

#include <vector>

#include "pair.h"

namespace LAMMPS_NS {

class PairSevenNetTorch : public Pair {
 public:
  PairSevenNetTorch(class LAMMPS*);
  ~PairSevenNetTorch() override;
  void compute(int, int) override;
  void settings(int, char**) override;
  void coeff(int, char**) override;
  void init_style() override;

 protected:
  void allocate();

 private:
  int cap_node_ = 0;
  int cap_edge_ = 0;
  std::vector<int> z_of_type_;
  static int symbol_to_z(const char* sym);
};

}  // namespace LAMMPS_NS

#endif
#endif
