"""The port's brick decomposition (``parallel/brick.py``) against the JAX
package's, array for array, on the slab, pencil and brick meshes of the
JAX parallel tests and on denser boxes: ownership, halo phases, shifts
and the dense grid. The one documented difference is the grid's row
count: the JAX package rounds it up to its TPU kernels' aggregation block,
the port keeps ``cap_all * deg_cap`` rows (its kernels want a multiple of
the degree), so the port's grid is the JAX grid's first rows and the JAX
rows past them are masked pads. Also the grid's own contract: every row
a center's, the reverse-edge permutation an involution pairing (i, j)
with (j, i), and the masked edge set symmetric.
"""

import numpy as np
import pytest

from sevennet_exp_tpu.parallel.brick import decompose_brick as jdecompose
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.parallel.brick import decompose_brick
from test_parallel import _long_box
from test_parallel2d import _flat_box
from test_parallel3d import _cube

CASES = {
    'slab': (_long_box, (2,), None),
    'slab4': (_long_box, (4,), None),
    'pencil': (_flat_box, (2, 2), None),
    'pencil_yz': (_cube, (2, 2), (1, 2)),
    'brick': (_cube, (2, 2, 2), None),
}


def box(n, a=3.6, seed=0):
    """A rattled CsCl-like box of n = (nx, ny, nz) cells: at a = 3.6 A
    every atom has neighbours inside a 3.5 A cutoff (the JAX tests' boxes,
    a = 4.2 A, have a few dozen edges in all)."""
    from sevennet_exp_tpu.data.graph import Atoms as JAtoms
    rng = np.random.default_rng(seed)
    zs, fr = [], []
    nx, ny, nz = n
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                fr.append([(i + 0.25) / nx, (j + 0.25) / ny,
                           (k + 0.25) / nz])
                zs.append(11)
                fr.append([(i + 0.75) / nx, (j + 0.75) / ny,
                           (k + 0.75) / nz])
                zs.append(17)
    cell = np.diag([a * nx, a * ny, a * nz]).astype(float)
    pos = np.array(fr) @ cell + rng.normal(scale=0.05, size=(len(fr), 3))
    return JAtoms(atomic_numbers=np.array(zs), pos=pos, cell=cell,
                  pbc=np.array([True] * 3))


def _pair(make, mesh, axes, cutoff=4.0):
    at = make()
    port = decompose_brick(Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc),
                           mesh, cutoff, axes=axes)
    return port, jdecompose(at, mesh, cutoff, axes=axes)


def _assert_same(port, ref):
    assert port.cap_loc == ref.cap_loc and port.cap_g == ref.cap_g
    assert port.deg_cap == ref.deg_cap and port.mesh == ref.mesh
    for f in ('owner_perm', 'pos', 'z', 'loc_mask', 'n_loc', 'cell'):
        assert np.array_equal(getattr(port, f), getattr(ref, f)), f
    for k in range(len(port.mesh)):
        for f in ('send_idx', 'send_mask', 'shift'):
            assert np.array_equal(getattr(port, f)[k],
                                  getattr(ref, f)[k]), (f, k)
    # the row rule: cap_all * deg_cap here, rounded up to a block in JAX
    rows = port.rows
    assert rows == port.cap_all * port.deg_cap <= ref.rows
    assert np.array_equal(port.edge_idx, ref.edge_idx[:, :, :rows])
    assert np.array_equal(port.edge_mask, ref.edge_mask[:, :rows])
    assert np.array_equal(port.edge_rev, ref.edge_rev[:, :rows])
    assert not ref.edge_mask[:, rows:].any()


@pytest.mark.parametrize('case', sorted(CASES))
def test_decompose_matches_jax(case):
    make, mesh, axes = CASES[case]
    _assert_same(*_pair(make, mesh, axes))


@pytest.mark.parametrize('n,mesh', [((12, 3, 3), (4,)), ((6, 6, 3), (2, 2)),
                                    ((4, 4, 4), (2, 2, 2))])
def test_decompose_matches_jax_dense(n, mesh):
    port, ref = _pair(lambda: box(n), mesh, None)
    _assert_same(port, ref)
    assert port.edge_mask.sum() > 20 * len(port.owner_perm)


def test_capacities_kept_while_they_fit():
    at = box((4, 4, 4))
    pat = Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)
    first = decompose_brick(pat, (2, 2, 2), 4.0, cap_margin=1.5)
    again = decompose_brick(pat, (2, 2, 2), 4.0, prev=first)
    assert (again.cap_loc, again.cap_g, again.deg_cap, again.rows) == (
        first.cap_loc, first.cap_g, first.deg_cap, first.rows)
    ref = jdecompose(at, (2, 2, 2), 4.0, cap_margin=1.5)
    assert (first.cap_loc, first.cap_g) == (ref.cap_loc, ref.cap_g)


@pytest.mark.parametrize('n,mesh', [((12, 3, 3), (2,)), ((6, 6, 3), (2, 2)),
                                    ((4, 4, 4), (2, 2, 2))])
def test_grid_is_symmetric_and_rev_pairs_reverses(n, mesh):
    at = box(n)
    spec = decompose_brick(Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc),
                           mesh, 4.0)
    deg, rows = spec.deg_cap, spec.rows
    assert rows % deg == 0 and rows // deg == spec.cap_all
    for d in range(spec.edge_idx.shape[0]):
        dst, src = spec.edge_idx[d]
        mask, rev = spec.edge_mask[d] > 0, spec.edge_rev[d]
        assert np.array_equal(dst, np.arange(rows) // deg)
        # pads are self-edges
        assert np.array_equal(src[~mask], dst[~mask])
        # rev is an involution that swaps the ends of every row
        assert np.array_equal(rev[rev], np.arange(rows))
        assert np.array_equal(dst[rev], src) and np.array_equal(src[rev], dst)
        assert np.array_equal(mask[rev], mask)
        # the masked edge set is symmetric, each edge once
        pairs = set(zip(dst[mask].tolist(), src[mask].tolist()))
        assert len(pairs) == int(mask.sum())
        assert pairs == {(j, i) for i, j in pairs}


def test_undecomposed_axes_take_the_minimum_image():
    at = box((4, 4, 4))
    pat = Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)
    assert decompose_brick(pat, (2,), 4.0).mic_axes == (1, 2)
    assert decompose_brick(pat, (2, 2), 4.0, axes=(0, 2)).mic_axes == (1,)
    assert decompose_brick(pat, (2, 1), 4.0).mic_axes == (1, 2)
    assert decompose_brick(pat, (2, 2, 2), 4.0).mic_axes == ()
