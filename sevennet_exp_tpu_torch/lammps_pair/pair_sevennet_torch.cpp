// LAMMPS pair style driving a deployed artifact of the PyTorch port
// (sevennet_exp_tpu_torch/scripts/deploy.py: an AOTInductor package whose
// convolutions, on the card, are the hand-written edge-pair kernels)
// through libsevenn_exec (sevennet_exp_tpu_torch/csrc/sevenn_exec.cpp) --
// the counterpart of the reference's pair_e3gnn.cpp + patch_lammps.sh
// flow (there, a TorchScript model executes inside the pair style).
// The pair style is serial per rank, as the reference's e3gnn style is.
//
// The repository ships no LAMMPS source tree: the style is compiled and
// driven against the mock LAMMPS headers (lammps_pair/mock/, harness.cpp;
// tests/test_torch_lammps_pair.py). To integrate:
//
//   1. python -m sevennet_exp_tpu_torch.main.cli get_model CKPT -o dep
//   2. python -m sevennet_exp_tpu_torch.main.cli patch_lammps lammps/src
//      (copies this file + pair_sevennet_torch.h, prints where
//      libsevenn_exec.so was built)
//   3. add libsevenn_exec.so to the LAMMPS link line and build
//   4. pair_style sevennet_torch dep/
//      pair_coeff * * Na Cl
//
// Conventions mirrored from the reference pair style
// (pair_e3gnn.cpp):
//   - full neighbor lists; periodic ghosts are tag-mapped back to their
//     local owner (pair_e3gnn.cpp:168-190) so the graph folds onto
//     nlocal nodes and reaction forces land on owned atoms directly
//   - edge_vec = x[j] - x[i] computed from the ghost image coordinate
//     (so the displacement carries the PBC shift), destination i =
//     edge_idx row 0
//   - per-step virial from the returned Voigt stress * volume
//
// The deployed capacities (signature.yaml n_node/n_edge) bound the
// local atom and edge counts; redeploy with larger --n-node/--n-edge
// for bigger subdomains.

#ifdef LAMMPS_VERSION_NUMBER  // only meaningful inside a LAMMPS tree

#include "pair_sevennet_torch.h"

#include <cstring>
#include <vector>

#include "atom.h"
#include "comm.h"
#include "domain.h"
#include "error.h"
#include "force.h"
#include "memory.h"
#include "neigh_list.h"
#include "neigh_request.h"
#include "neighbor.h"

extern "C" {
int sevenn_exec_init(const char* artifact_dir);
int sevenn_exec_capacity(int* n_node, int* n_edge);
int sevenn_exec_run(const int* z, const int* edge_idx,
                    const float* edge_vec, const float* edge_mask,
                    const float* node_mask, float cell_volume,
                    float* energy, float* forces, float* stress);
int sevenn_exec_free();
}

using namespace LAMMPS_NS;

namespace {
const char* const kSymbols[] = {
    "X",  "H",  "He", "Li", "Be", "B",  "C",  "N",  "O",  "F",  "Ne",
    "Na", "Mg", "Al", "Si", "P",  "S",  "Cl", "Ar", "K",  "Ca", "Sc",
    "Ti", "V",  "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn", "Ga", "Ge",
    "As", "Se", "Br", "Kr", "Rb", "Sr", "Y",  "Zr", "Nb", "Mo", "Tc",
    "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn", "Sb", "Te", "I",  "Xe",
    "Cs", "Ba", "La", "Ce", "Pr", "Nd", "Pm", "Sm", "Eu", "Gd", "Tb",
    "Dy", "Ho", "Er", "Tm", "Yb", "Lu", "Hf", "Ta", "W",  "Re", "Os",
    "Ir", "Pt", "Au", "Hg", "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr",
    "Ra", "Ac", "Th", "Pa", "U",  "Np", "Pu", "Am", "Cm", "Bk", "Cf",
    "Es", "Fm", "Md", "No", "Lr"};
}  // namespace

int PairSevenNetTorch::symbol_to_z(const char* sym) {
  for (int z = 1; z < static_cast<int>(sizeof(kSymbols) / sizeof(*kSymbols));
       ++z)
    if (std::strcmp(sym, kSymbols[z]) == 0) return z;
  return 0;
}

PairSevenNetTorch::PairSevenNetTorch(LAMMPS* lmp) : Pair(lmp) {
  single_enable = 0;
  restartinfo = 0;
  one_coeff = 1;
  manybody_flag = 1;
}

PairSevenNetTorch::~PairSevenNetTorch() {
  sevenn_exec_free();
  if (allocated) {
    memory->destroy(setflag);
    memory->destroy(cutsq);
  }
}

void PairSevenNetTorch::allocate() {
  allocated = 1;
  const int n = atom->ntypes + 1;
  memory->create(setflag, n, n, "pair:setflag");
  memory->create(cutsq, n, n, "pair:cutsq");
  for (int i = 1; i < n; ++i)
    for (int j = i; j < n; ++j) setflag[i][j] = 1;
}

void PairSevenNetTorch::settings(int narg, char** arg) {
  if (narg != 1) error->all(FLERR, "pair_style sevennet_torch <artifact>");
  if (sevenn_exec_init(arg[0]) != 0)
    error->all(FLERR, "sevennet_torch: artifact init failed");
  sevenn_exec_capacity(&cap_node_, &cap_edge_);
}

void PairSevenNetTorch::coeff(int narg, char** arg) {
  // pair_coeff * * <element for type 1> <element for type 2> ...
  // (the model path lives in pair_style settings, so elements start at
  // arg[2] -- unlike the reference, whose arg[2] is the model path)
  if (!allocated) allocate();
  z_of_type_.clear();
  for (int i = 2; i < narg; ++i) {
    const int z = symbol_to_z(arg[i]);
    if (z == 0) error->all(FLERR, "sevennet_torch: unknown element symbol");
    z_of_type_.push_back(z);
  }
  if (static_cast<int>(z_of_type_.size()) != atom->ntypes)
    error->all(FLERR, "sevennet_torch: one element per atom type required");
}

void PairSevenNetTorch::compute(int eflag, int vflag) {
  ev_init(eflag, vflag);
  const int nlocal = atom->nlocal;
  if (nlocal > cap_node_)
    error->one(FLERR, "sevennet_torch: n_node capacity exceeded; "
                      "redeploy with a larger --n-node");

  std::vector<int> z(cap_node_, 0);
  std::vector<float> node_mask(cap_node_, 0.f);
  for (int i = 0; i < nlocal; ++i) {
    z[i] = z_of_type_[atom->type[i] - 1];
    node_mask[i] = 1.f;
  }

  // Symmetric edge list over LOCAL nodes only: a neighbor j that is a
  // ghost is folded back to its owning local atom via tag->map (the
  // reference convention, pair_e3gnn.cpp:168-190), while edge_vec uses
  // the ghost image coordinate so the periodic shift is preserved.
  std::vector<int> eidx(2 * cap_edge_, cap_node_ - 1);
  // padding rows carry a unit dummy vector: a zero displacement would
  // put r=0 through the radial basis and the resulting NaN survives
  // masking (NaN * 0 = NaN) — same convention as the python collater
  std::vector<float> evec(3 * cap_edge_, 0.f);
  for (int k = 0; k < cap_edge_; ++k) evec[3 * k] = 1.f;
  std::vector<float> emask(cap_edge_, 0.f);
  int ne = 0;
  NeighList* l = list;
  for (int ii = 0; ii < l->inum; ++ii) {
    const int i = l->ilist[ii];
    if (i >= nlocal) continue;
    for (int jj = 0; jj < l->numneigh[i]; ++jj) {
      const int j = l->firstneigh[i][jj] & NEIGHMASK;
      int jl = j;
      if (j >= nlocal) {
        jl = atom->map(atom->tag[j]);
        if (jl < 0 || jl >= nlocal)
          error->one(FLERR, "sevennet_torch: ghost atom has no local owner "
                            "(requires atom_modify map yes)");
      }
      if (ne >= cap_edge_)
        error->one(FLERR, "sevennet_torch: n_edge capacity exceeded");
      eidx[ne] = i;                  // row 0: destination (local)
      eidx[cap_edge_ + ne] = jl;     // row 1: source owner (local)
      for (int d = 0; d < 3; ++d)
        evec[3 * ne + d] =
            static_cast<float>(atom->x[j][d] - atom->x[i][d]);
      emask[ne] = 1.f;
      ++ne;
    }
  }

  float e = 0.f, stress[6];
  std::vector<float> f(3 * cap_node_, 0.f);
  const float vol = static_cast<float>(domain->xprd * domain->yprd *
                                       domain->zprd);
  if (sevenn_exec_run(z.data(), eidx.data(), evec.data(), emask.data(),
                      node_mask.data(), vol, &e, f.data(), stress) != 0)
    error->one(FLERR, "sevennet_torch: execute failed");

  for (int i = 0; i < nlocal; ++i)
    for (int d = 0; d < 3; ++d) atom->f[i][d] += f[3 * i + d];
  if (eflag_global) eng_vdwl += e;
  if (vflag_global) {
    // model stress is -virial/V in Voigt (xx yy zz xy yz zx)
    virial[0] -= stress[0] * vol;
    virial[1] -= stress[1] * vol;
    virial[2] -= stress[2] * vol;
    virial[3] -= stress[3] * vol;  // xy
    virial[4] -= stress[5] * vol;  // xz (model zx)
    virial[5] -= stress[4] * vol;  // yz
  }
}

void PairSevenNetTorch::init_style() {
  if (atom->map_style == Atom::MAP_NONE)
    error->all(FLERR, "sevennet_torch requires atom map (atom_modify map yes)");
  neighbor->add_request(this, NeighConst::REQ_FULL);
}

#endif  // LAMMPS_VERSION_NUMBER
