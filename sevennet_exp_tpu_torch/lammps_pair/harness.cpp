// Standalone program that runs the port's LAMMPS pair style sevennet_torch,
// using the mock LAMMPS world in lammps_pair/mock/. It stands in for the
// LAMMPS engine: builds ghost atoms + a full neighbor list for an
// orthorhombic periodic box, then runs the UNMODIFIED pair style
// (settings -> coeff -> init_style -> compute) against a deployed
// artifact through libsevenn_exec. tests/test_torch_lammps_pair.py compares
// the resulting E/F/virial with model.apply — the same end-to-end
// check the reference gets from running real LAMMPS over
// pair_e3gnn.cpp.
//
// usage: harness <artifact_dir> <cutoff> <structure.txt> <out.txt>
//                <elem_type1> [elem_type2 ...]
// structure.txt: natoms / Lx Ly Lz / natoms lines of: type x y z
// out.txt: energy / nlocal force rows / virial row (17 sig digits)

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "atom.h"
#include "comm.h"
#include "domain.h"
#include "error.h"
#include "force.h"
#include "lammps.h"
#include "memory.h"
#include "neigh_list.h"
#include "neighbor.h"
#include "pair_sevennet_torch.h"

using namespace LAMMPS_NS;

int main(int argc, char** argv) {
  if (argc < 6) {
    std::fprintf(stderr,
                 "usage: %s <artifact_dir> <cutoff> <structure.txt> "
                 "<out.txt> <elem1> [elem2 ...]\n",
                 argv[0]);
    return 2;
  }
  const char* artifact = argv[1];
  const double cutoff = std::atof(argv[2]);

  FILE* sf = std::fopen(argv[3], "r");
  if (!sf) {
    std::fprintf(stderr, "cannot open %s\n", argv[3]);
    return 2;
  }
  int nlocal = 0;
  double L[3] = {0, 0, 0};
  if (std::fscanf(sf, "%d", &nlocal) != 1 ||
      std::fscanf(sf, "%lf %lf %lf", &L[0], &L[1], &L[2]) != 3) {
    std::fprintf(stderr, "bad structure header\n");
    return 2;
  }
  std::vector<int> ltype(nlocal);
  std::vector<double> lpos(3 * nlocal);
  for (int i = 0; i < nlocal; ++i) {
    if (std::fscanf(sf, "%d %lf %lf %lf", &ltype[i], &lpos[3 * i],
                    &lpos[3 * i + 1], &lpos[3 * i + 2]) != 4) {
      std::fprintf(stderr, "bad structure row %d\n", i);
      return 2;
    }
  }
  std::fclose(sf);

  // --- mock LAMMPS world -------------------------------------------
  LAMMPS lmp;
  Atom atom_;
  Comm comm_;
  Domain domain_;
  Error error_;
  Force force_;
  Memory memory_;
  Neighbor neighbor_;
  lmp.atom = &atom_;
  lmp.comm = &comm_;
  lmp.domain = &domain_;
  lmp.error = &error_;
  lmp.force = &force_;
  lmp.memory = &memory_;
  lmp.neighbor = &neighbor_;

  domain_.xprd = L[0];
  domain_.yprd = L[1];
  domain_.zprd = L[2];

  int ntypes = 0;
  for (int i = 0; i < nlocal; ++i)
    if (ltype[i] > ntypes) ntypes = ltype[i];
  atom_.ntypes = ntypes;
  if (argc - 5 != ntypes) {
    std::fprintf(stderr, "need %d element symbols, got %d\n", ntypes,
                 argc - 5);
    return 2;
  }

  // ghosts: every periodic image (27-cell stencil) of a local atom that
  // lies within the cutoff of any local atom — what comm->borders()
  // provides in real LAMMPS for an all-in-one-proc box
  std::vector<int> gtype;
  std::vector<tagint> gtag;
  std::vector<double> gpos;
  const double rc2 = cutoff * cutoff;
  for (int i = 0; i < nlocal; ++i) {
    for (int sx = -1; sx <= 1; ++sx)
      for (int sy = -1; sy <= 1; ++sy)
        for (int sz = -1; sz <= 1; ++sz) {
          if (sx == 0 && sy == 0 && sz == 0) continue;
          const double gx = lpos[3 * i] + sx * L[0];
          const double gy = lpos[3 * i + 1] + sy * L[1];
          const double gz = lpos[3 * i + 2] + sz * L[2];
          bool near = false;
          for (int k = 0; k < nlocal && !near; ++k) {
            const double dx = gx - lpos[3 * k];
            const double dy = gy - lpos[3 * k + 1];
            const double dz = gz - lpos[3 * k + 2];
            near = dx * dx + dy * dy + dz * dz < rc2;
          }
          if (!near) continue;
          gtype.push_back(ltype[i]);
          gtag.push_back(i + 1);
          gpos.push_back(gx);
          gpos.push_back(gy);
          gpos.push_back(gz);
        }
  }
  const int nghost = static_cast<int>(gtype.size());
  const int nall = nlocal + nghost;
  atom_.nlocal = nlocal;
  atom_.nghost = nghost;

  std::vector<int> type(nall);
  std::vector<tagint> tag(nall);
  memory_.create(atom_.x, nall, 3, "harness:x");
  memory_.create(atom_.f, nall, 3, "harness:f");
  for (int i = 0; i < nlocal; ++i) {
    type[i] = ltype[i];
    tag[i] = i + 1;
    for (int d = 0; d < 3; ++d) atom_.x[i][d] = lpos[3 * i + d];
  }
  for (int g = 0; g < nghost; ++g) {
    type[nlocal + g] = gtype[g];
    tag[nlocal + g] = gtag[g];
    for (int d = 0; d < 3; ++d) atom_.x[nlocal + g][d] = gpos[3 * g + d];
  }
  atom_.type = type.data();
  atom_.tag = tag.data();
  atom_.map_store.assign(nlocal + 1, -1);
  for (int i = 0; i < nlocal; ++i) atom_.map_store[i + 1] = i;

  // full neighbor list: for each local i, every other atom (local or
  // ghost image) strictly within the cutoff
  NeighList nlist;
  std::vector<int> ilist(nlocal), numneigh(nlocal);
  std::vector<int*> firstneigh(nlocal);
  std::vector<std::vector<int>> neigh(nlocal);
  for (int i = 0; i < nlocal; ++i) {
    for (int j = 0; j < nall; ++j) {
      if (j == i) continue;
      const double dx = atom_.x[j][0] - atom_.x[i][0];
      const double dy = atom_.x[j][1] - atom_.x[i][1];
      const double dz = atom_.x[j][2] - atom_.x[i][2];
      if (dx * dx + dy * dy + dz * dz < rc2) neigh[i].push_back(j);
    }
    ilist[i] = i;
    numneigh[i] = static_cast<int>(neigh[i].size());
    firstneigh[i] = neigh[i].data();
  }
  nlist.inum = nlocal;
  nlist.ilist = ilist.data();
  nlist.numneigh = numneigh.data();
  nlist.firstneigh = firstneigh.data();

  // --- drive the pair style exactly as LAMMPS would ----------------
  PairSevenNetTorch pair(&lmp);
  char* sargs[] = {const_cast<char*>(artifact)};
  pair.settings(1, sargs);
  std::vector<char*> cargs;
  char star[] = "*";
  cargs.push_back(star);
  cargs.push_back(star);
  for (int t = 0; t < ntypes; ++t) cargs.push_back(argv[5 + t]);
  pair.coeff(static_cast<int>(cargs.size()), cargs.data());
  pair.init_style();
  if (neighbor_.requested_flags != NeighConst::REQ_FULL) {
    std::fprintf(stderr, "pair style did not request a full list\n");
    return 1;
  }
  pair.list = &nlist;
  pair.compute(/*eflag=*/1, /*vflag=*/1);

  FILE* of = std::fopen(argv[4], "w");
  if (!of) {
    std::fprintf(stderr, "cannot open %s\n", argv[4]);
    return 2;
  }
  std::fprintf(of, "%.17g\n", pair.eng_vdwl);
  for (int i = 0; i < nlocal; ++i)
    std::fprintf(of, "%.17g %.17g %.17g\n", atom_.f[i][0], atom_.f[i][1],
                 atom_.f[i][2]);
  for (int k = 0; k < 6; ++k) std::fprintf(of, "%.17g ", pair.virial[k]);
  std::fprintf(of, "\n");
  std::fclose(of);

  memory_.destroy(atom_.x);
  memory_.destroy(atom_.f);
  std::printf("harness ok: nlocal=%d nghost=%d edges=%d\n", nlocal, nghost,
              [&] {
                int ne = 0;
                for (int i = 0; i < nlocal; ++i) ne += numneigh[i];
                return ne;
              }());
  return 0;
}
