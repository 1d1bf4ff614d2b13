"""CUDA kernels of the port against their plain PyTorch versions, on the
card. The kernels have no CPU mode, so off the card every test here
skips. Run on a machine with an NVIDIA GPU (no JAX needed there):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')


@pytest.fixture(scope='module')
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(scope='module')
def model(cuda):
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    return SevenNetCheckpoint(CKPT).build_model(device=cuda)[0]


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_fused_conv_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree)
    mw, sw = cl.weight_nn_p.as_dict(), cl.si2_p.as_dict()
    mlp_ws = tuple(mw[f'w{i}'] for i in range(3))
    si2_ws = tuple(sw[f'w{n}'] for n in range(len(sw)))
    rng = np.random.default_rng(layer)
    n = 37
    rows = n * degree

    def t(*shape, lo=None):
        a = (rng.uniform(0.0, lo, size=shape) if lo
             else rng.normal(size=shape))
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    xg, sh, emb = t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb)
    ms = t(rows, 1, lo=0.05)
    ms[torch.rand(rows, device=cuda) < 0.2] = 0.0
    g = t(n, conv.d_out)
    y_k = conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                         si2_ws),
                    conv.plain_backward(g, xg, sh, emb, ms, mlp_ws,
                                        si2_ws)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


def test_fused_conv_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    conv = FusedConv(tp, mlp, si2, 16)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    n = 11
    rows = n * 16
    xg, shv, emb = t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb)
    ms = torch.full((rows, 1), 0.05, device=cuda)
    g = t(n, conv.d_out)
    y_k = conv.kernel_forward(xg, shv, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, shv, emb, ms, mlp_ws, si2_ws)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(conv.kernel_backward(g, xg, shv, emb, ms, mlp_ws,
                                         si2_ws),
                    conv.plain_backward(g, xg, shv, emb, ms, mlp_ws,
                                        si2_ws)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


@pytest.mark.parametrize('layer', [0, 1, 4])
def test_dense_kernels_pad_rows_zero_and_runs_bit_identical(cuda, model,
                                                            layer):
    """Kernels 1-2 (the geometry-fused pair's template without the
    geometry): pad rows (ms = 0, their sh and emb rows random) get exact-zero
    dxg, dsh and demb, and two launches give the same bits (no atomics)."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 32)
    mlp_ws, si2_ws = cl._weights()
    xg, sh, emb, ms, g, pad = _plain_inputs(conv, 37 * 32, cuda, 80 + layer)
    outs = []
    for _ in range(2):
        outs.append((conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws),
                     *conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                           si2_ws)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for d in outs[0][1:]:
        assert torch.isfinite(d).all()
        assert d[pad].abs().max() == 0


def test_dense_kernels_resources(cuda, model):
    """As compiled: no local memory, three forward and two backward blocks
    an SM at every layer's shared bytes; the launch shape is the Python
    mirror's."""
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    for layer in range(5):
        cl = model.layers[f'{layer}_convolution']
        conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 32)
        dims = fcg.layer_dims(conv, 32)
        for bwd, blocks in ((False, 3), (True, 2)):
            assert fcg.kernel_shape(dims, bwd, False) == fcg.shape(
                dims, bwd, False)
            r = fcg.kernel_resources(dims, conv.f, bwd, False)
            assert r.local_bytes == 0 and r.blocks_per_sm >= blocks, r
            assert r.smem == fcg.shape(dims, bwd, False).smem


def test_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32)
    mw, sw = cl.weight_nn_p.as_dict(), cl.si2_p.as_dict()
    rows = 4 * 32
    xg = torch.randn(rows, conv.d1, device=cuda, requires_grad=True)
    sh = torch.randn(rows, conv.f, device=cuda)
    emb = torch.randn(rows, conv.nb, device=cuda)
    ms = torch.full((rows, 1), 0.04, device=cuda)
    fc.reset_launch_counts()
    out = conv(xg, sh, emb, ms, tuple(mw[f'w{i}'] for i in range(3)),
               tuple(sw[f'w{n}'] for n in range(len(sw))))
    out.sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_fwd'] = want['fused_conv_bwd'] = 1
    assert fc.launch_counts == want


# -- the geometry-fused pair ------------------------------------------------

def _geom_inputs(conv, n, degree, cuda, seed):
    """Edge vectors up to just past the cutoff, with pad rows (ms = 0 and
    the unit vector) and rows inside r_on."""
    rng = np.random.default_rng(seed)
    rows = n * degree
    rc = conv.geom.cutoff

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    u = rng.normal(size=(rows, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = u * rng.uniform(0.3 * rc, 1.02 * rc, size=(rows, 1))
    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    vec[pad] = [1.0, 0.0, 0.0]
    coeffs = np.arange(1, conv.nb + 1) * np.pi / rc
    return (t(rng.normal(size=(rows, conv.d1))), t(vec), t(ms), t(coeffs),
            t(rng.normal(size=(n, conv.d_out))), torch.tensor(pad))


def _assert_geom_kernels_match_plain(conv, args, mlp_ws, si2_ws):
    xg, vec, ms, coeffs, g, pad = args
    y_k = conv.kernel_geom_forward(xg, vec, ms, coeffs, mlp_ws, si2_ws)
    y_p = conv.plain_geom_forward(xg, vec, ms, coeffs, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    d_k = conv.kernel_geom_backward(g, xg, vec, ms, coeffs, mlp_ws, si2_ws)
    d_p = conv.plain_geom_backward(g, xg, vec, ms, coeffs, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    for a, b in zip(d_k, d_p):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad.to(a.device)].abs().max() == 0     # pad rows: zeros


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_geom_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, geom=cl.geom)
    mlp_ws, si2_ws = cl._weights()
    _assert_geom_kernels_match_plain(
        conv, _geom_inputs(conv, 37, degree, cuda, layer), mlp_ws, si2_ws)


@pytest.mark.parametrize('kind', ['poly', 'xplor'])
@pytest.mark.parametrize('lmax', [1, 2, 3])
def test_geom_kernels_random_plans(cuda, kind, lmax):
    """Multiplicity 4 (not a multiple of a warp), l up to 3, both
    envelopes, 10 Bessel functions."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv, GeomSpec
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('+'.join(f'4x{l}{"eo"[l % 2]}' for l in range(lmax + 1)))
    sh = Irreps.spherical_harmonics(lmax, -1)
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, lmax, 'full'))
    nb = 10
    mlp = FullyConnectedNetSpec((nb, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    geom = GeomSpec(cutoff=4.0, num_basis=nb, lmax=lmax, cutoff_kind=kind,
                    cutoff_p=6.0, cutoff_on=3.5 if kind == 'xplor' else 0.0)
    conv = FusedConv(tp, mlp, si2, 16, geom=geom)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    _assert_geom_kernels_match_plain(
        conv, _geom_inputs(conv, 11, 16, cuda, lmax), mlp_ws, si2_ws)


def test_geom_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, geom=cl.geom)
    xg, vec, ms, coeffs, _, _ = _geom_inputs(conv, 4, 32, cuda, 0)
    xg.requires_grad_(True)
    vec.requires_grad_(True)
    fc.reset_launch_counts()
    out = conv.apply_geom(xg, vec, ms, coeffs, *cl._weights())
    out.sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_geom_fwd'] = want['fused_conv_geom_bwd'] = 1
    assert fc.launch_counts == want
    assert xg.grad is not None and vec.grad is not None


def test_geom_kernels_match_plain_at_97k_chunk_shape(cuda, model):
    """Checkpoint layer 1 at the 97k leg's shapes: one full chunk (16,384
    atoms x 32 rows) and the 40-atom remainder chunk, with pad rows."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers['1_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, geom=cl.geom)
    mlp_ws, si2_ws = cl._weights()
    for n_atoms in (16384, 40):
        _assert_geom_kernels_match_plain(
            conv, _geom_inputs(conv, n_atoms, 32, cuda, n_atoms), mlp_ws,
            si2_ws)
        torch.cuda.empty_cache()


def test_geom_launch_shape_matches_python_mirror(cuda, model):
    """The C entry's tile, row groups and shared bytes are those of
    ops/fused_conv_geom.py (which the CPU tests hold), for the
    geometry-fused pair and the dense pair."""
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    for layer in (0, 1, 4):
        cl = model.layers[f'{layer}_convolution']
        for D in (16, 32, 40, 6):
            conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, D, geom=cl.geom)
            dims = fcg.layer_dims(conv, D)
            for bwd in (False, True):
                for geom in (True, False):
                    assert fcg.kernel_shape(dims, bwd, geom) == fcg.shape(
                        dims, bwd, geom)
        # the edge pair (D not read)
        conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
        dims = fcg.layer_dims(conv, 0)
        for bwd in (False, True):
            assert fcg.kernel_shape(dims, bwd, edge=True) == fcg.shape(
                dims, bwd, edge=True)


def _geom_source_instances(pair):
    """{label: opcode counts} of csrc/fused_conv_geom.cu's kernel instances
    of one pair ('geom': rows 5-6; 'dense': kernels 1-2; 'edge': their
    edge-row form; with '_ssp', of the shifted-softplus build), labelled
    fwd, bwd4, bwd9, bwd16."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    base = pair.removesuffix('_ssp')
    lib = 'fused_conv_geom_ssp' if base != pair else 'fused_conv_geom'
    return {sass_compare.geom_label(k): v
            for k, v in sass_compare.count(lib).items()
            if sass_compare.geom_pair(k) == base}


@pytest.mark.parametrize('pair', ['geom', 'dense', 'edge', 'geom_ssp',
                                  'dense_ssp', 'edge_ssp'])
def test_geom_kernels_sass_fp32_cuda_cores_no_local_memory(cuda, pair):
    """Rows 5-6, kernels 1-2 and their edge-row form: FFMA on the CUDA
    cores, no tensor-core opcode, nothing in local memory (no spill, no
    stack array), in every instance, the shifted-softplus ones too."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = _geom_source_instances(pair)
    # forward, backward at 4, 9, 16 SH
    assert set(counts) == {'fwd', 'bwd4', 'bwd9', 'bwd16'}
    for k, v in counts.items():
        assert v['FFMA'] > 0, k
        for op in (*sass_compare.TENSOR_CORE_OPS, *sass_compare.LOCAL_OPS):
            assert v[op] == 0, (k, op, v[op])


# SASS digests of the geometry-fused pair (rows 5-6) built from the tree
# before the dense pair joined their template (and before the edge pair
# did), by label (sass_compare.geom_label), same nvcc on the card machine
PARENT_GEOM_SASS = {'fwd': '282ef8d7e2ab', 'bwd4': '9eca060d6abd',
                    'bwd9': '4fded89d1077', 'bwd16': 'daa9f3ecb780'}


def test_geom_instances_sass_identical_to_parent(cuda):
    """The template switches leave rows 5-6 as they were compiled: each
    geom instance's SASS digest is the earlier kernel's."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {sass_compare.geom_label(k): v for k, v in
           sass_compare.digests('fused_conv_geom').items()
           if sass_compare.geom_pair(k) == 'geom'}
    assert got == PARENT_GEOM_SASS


# SASS digests of the dense pair (kernels 1-2) built from the tree before
# the edge pair joined csrc/fused_conv_geom.cu, by label, same nvcc on the
# card machine
PARENT_DENSE_SASS = {'fwd': 'ed74768ed1fc', 'bwd4': 'c79437837836',
                     'bwd9': '28421c2cd7d5', 'bwd16': '5128e637db46'}


def test_dense_instances_sass_identical_to_parent(cuda):
    """The edge pair joins the template as its third mode: each dense
    instance's SASS digest is the earlier kernel's."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {sass_compare.geom_label(k): v for k, v in
           sass_compare.digests('fused_conv_geom').items()
           if sass_compare.geom_pair(k) == 'dense'}
    assert got == PARENT_DENSE_SASS


# SASS digests of the edge pair (kernels 1-2 at agg_d = 0) built from the
# tree before the shifted softplus joined csrc/fused_conv_geom.cu, by
# label, same nvcc on the card machine
PARENT_EDGE_SASS = {'fwd': '1bd8cca68cf4', 'bwd4': '2b2ea3b3dae0',
                    'bwd9': '785447e4d5fa', 'bwd16': '3d5b2d34c0c5'}


def test_edge_instances_sass_identical_to_parent(cuda):
    """The shifted softplus is a build of its own: each edge instance of
    the silu / tanh build keeps the earlier kernel's SASS digest (the dense
    and geom ones: the two tests above)."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {sass_compare.geom_label(k): v for k, v in
           sass_compare.digests('fused_conv_geom').items()
           if sass_compare.geom_pair(k) == 'edge'}
    assert got == PARENT_EDGE_SASS


# SASS digests (tools/sass_compare.digests) of bench_pieces' four stubbed
# variants (csrc/fused_conv_geom.cu built as bench_pieces: the dense
# forward with one piece stubbed), by variant, from the first card run of
# the tree that moved them onto that template (nvcc of CUDA 12.8 on the
# card machine; full and -agg are kernel 1 and its edge form:
# test_bench_pieces_full_and_agg_are_kernel_1_and_its_edge_form)
PARENT_SASS = {'-mlp': '158b216f454f', '-cg': '6d28988a5e79',
               '-w': '6f903b70728b', '-si2': 'cb98b85c9b37'}


def _pieces_digests():
    """{variant: SASS digest} of the bench_pieces build."""
    from sevennet_exp_tpu_torch.tools import bench_pieces as bp
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {bp.variant_of(k): v for k, v in
           sass_compare.digests('bench_pieces').items()}
    assert set(got) == set(bp.VARIANTS)
    return got


def test_untouched_conv_kernels_sass_identical_to_parent(cuda):
    """bench_pieces' stubbed variants compile to the SASS they had when
    they moved onto the production forward (an edit of the template that
    moves them shows here)."""
    got = _pieces_digests()
    assert {v: got[v] for v in PARENT_SASS} == PARENT_SASS


# -- the external-weight pair ------------------------------------------------

def _extw_inputs(conv, n, degree, cuda, seed, mlp_ws=None):
    """xg, sh, weff = MLP(emb) * ms with pad rows (ms = 0, so weff rows
    of zeros), and a node cotangent."""
    rng = np.random.default_rng(seed)
    rows = n * degree

    def t(a):
        return torch.tensor(a, dtype=torch.float32, device=cuda)

    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    emb = t(rng.normal(size=(rows, conv.nb)))
    if mlp_ws is None:
        weff = t(rng.normal(size=(rows, conv.w_numel))) * t(ms)
    else:
        weff = conv.mlp.apply({f'w{i}': w for i, w in enumerate(mlp_ws)},
                              emb) * t(ms)
    return (t(rng.normal(size=(rows, conv.d1))),
            t(rng.normal(size=(rows, conv.f))), weff.contiguous(),
            t(rng.normal(size=(n, conv.d_out))),
            torch.tensor(pad, device=cuda))


def _assert_extw_kernels_match_plain(conv, args, si2_ws):
    xg, sh, weff, g, pad = args
    y_k = conv.kernel_extw_forward(xg, sh, weff, si2_ws)
    y_p = conv.plain_extw_forward(xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    d_k = conv.kernel_extw_backward(g, xg, sh, weff, si2_ws)
    d_p = conv.plain_extw_backward(g, xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    for a, b in zip(d_k, d_p):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad].abs().max() == 0                   # pad rows: zeros
    t = conv.kernel_tables(xg.device)
    if t.n_dead:                    # columns no instruction reads: zeros
        assert d_k[2][:, t.dead_w.long()].abs().max() == 0


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 40])
def test_extw_kernels_match_plain(cuda, model, layer, degree):
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, ext_w=True)
    mlp_ws, si2_ws = cl._weights()
    _assert_extw_kernels_match_plain(
        conv, _extw_inputs(conv, 37, degree, cuda, layer, mlp_ws), si2_ws)


def test_extw_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    conv = FusedConv(tp, mlp, si2, 16, ext_w=True)
    rng = np.random.default_rng(9)
    si2_ws = tuple(torch.tensor(rng.normal(size=si2.param_shapes()[f'w{n}']),
                                dtype=torch.float32, device=cuda)
                   for n in range(len(si2.paths)))
    _assert_extw_kernels_match_plain(
        conv, _extw_inputs(conv, 11, 16, cuda, 3), si2_ws)


def test_extw_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, ext_w=True)
    mlp_ws, si2_ws = cl._weights()
    xg, sh, weff, _, _ = _extw_inputs(conv, 4, 32, cuda, 0, mlp_ws)
    for t in (xg, sh, weff):
        t.requires_grad_(True)
    fc.reset_launch_counts()
    conv(xg, sh, weff, si2_ws).sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_extw_fwd'] = want['fused_conv_extw_bwd'] = 1
    assert fc.launch_counts == want
    assert weff.grad is not None and weff.grad.shape == weff.shape


# -- the edge-row contract (agg_d = 0) --------------------------------------

@pytest.mark.parametrize('layer', [0, 1, 4])
def test_edge_row_mode_matches_plain(cuda, model, layer):
    """agg_d = 0: one output row per edge, from the edge pair; 301 rows (a
    ragged last tile forward and backward) in no grid order, a fifth of them
    masked."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers[f'{layer}_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
    mlp_ws, si2_ws = cl._weights()
    rng = np.random.default_rng(20 + layer)
    rows = 301

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    xg, sh, emb, g = (t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb),
                      t(rows, conv.d_out))
    ms = torch.tensor(rng.uniform(0.01, 0.05, size=(rows, 1)),
                      dtype=torch.float32, device=cuda)
    ms[torch.tensor(rng.uniform(size=rows) < 0.2, device=cuda)] = 0.0
    fc.reset_launch_counts()
    y_k = conv.forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_k = conv.backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_edge_fwd'] = want['fused_conv_edge_bwd'] = 1
    assert fc.launch_counts == want
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = conv.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert tuple(y_k.shape) == (rows, conv.d_out)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(d_k, d_p):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


@pytest.mark.parametrize('layer', [0, 1, 4])
def test_edge_kernels_pad_rows_zero_and_runs_bit_identical(cuda, model,
                                                           layer):
    """The edge pair: pad rows (ms = 0, their sh and emb rows random) get
    exact-zero output, dxg, dsh and demb rows, tiles of pads only too (the
    last 53 rows, as the calculator pads its list), and two launches give
    the same bits (no atomics)."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
    mlp_ws, si2_ws = cl._weights()
    xg, sh, emb, ms, g, pad = _plain_inputs(conv, 301, cuda, 90 + layer)
    ms[-53:] = 0.0
    pad[-53:] = True
    outs = []
    for _ in range(2):
        outs.append((conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws),
                     *conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws,
                                           si2_ws)))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*outs))
    for d in outs[0]:
        assert torch.isfinite(d).all()
        assert d[pad].abs().max() == 0


@pytest.mark.parametrize('mul', [3, 4])
def test_edge_kernels_small_multiplicities(cuda, mul):
    """The edge pair on multiplicities under a warp and l up to 3; with 3
    the si2 groups' offsets are not multiples of 4 (the products' scalar
    loads and stores), with 4 they are."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('+'.join(f'{mul}x{l}{"eo"[l % 2]}' for l in range(4)))
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    conv = FusedConv(tp, mlp, si2, 0)
    rng = np.random.default_rng(mul)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    xg, sh_, emb, ms, g, pad = _plain_inputs(conv, 173, cuda, 40 + mul)
    y_k = conv.kernel_forward(xg, sh_, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, sh_, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    assert y_k[pad].abs().max() == 0
    for a, b in zip(conv.kernel_backward(g, xg, sh_, emb, ms, mlp_ws,
                                         si2_ws),
                    conv.plain_backward(g, xg, sh_, emb, ms, mlp_ws,
                                        si2_ws)):
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad].abs().max() == 0


def test_edge_kernels_resources(cuda, model):
    """As compiled: no local memory, at least two blocks an SM each way at
    every layer's shared bytes; the launch shape is the Python mirror's."""
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    for layer in range(5):
        cl = model.layers[f'{layer}_convolution']
        conv = FusedConv(cl.tp, cl.weight_nn, cl.si2, 0)
        dims = fcg.layer_dims(conv, 0)
        for bwd in (False, True):
            r = fcg.kernel_resources(dims, conv.f, bwd, edge=True)
            assert r.local_bytes == 0 and r.blocks_per_sm >= 2, r
            assert r.smem == fcg.shape(dims, bwd, edge=True).smem


def test_calculator_on_the_card_matches_cpu(cuda, model):
    """E, F and stress of a sheared 64-atom NaCl: the card (the edge pair +
    index_add_) against the CPU (plain versions). fp32 on both: E 1e-4 eV,
    F 1e-4 eV/A, stress 1e-6 eV/A^3."""
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(64, rattle=0.1, seed=1)
    strain = np.eye(3) + np.array([[0.02, 0.01, 0.008], [0.01, -0.01, 0.015],
                                   [0.008, 0.015, 0.0]])
    at = Atoms(at.atomic_numbers, at.pos @ strain, at.cell @ strain, at.pbc)
    fc.reset_launch_counts()
    res = SevenNetCalculator(model, device=cuda).calculate(at)
    assert fc.launch_counts['fused_conv_edge_fwd'] == 5
    assert fc.launch_counts['fused_conv_edge_bwd'] == 5
    import copy
    ref = SevenNetCalculator(copy.deepcopy(model), device='cpu').calculate(at)
    assert abs(res['energy'] - ref['energy']) <= 1e-4
    assert np.abs(res['forces'] - ref['forces']).max() <= 1e-4
    assert np.abs(res['stress'] - ref['stress']).max() <= 1e-6


# -- the terms pair (cg_mode='terms') ----------------------------------------

def _plain_inputs(conv, rows, cuda, seed):
    """xg, sh, emb, ms (a fifth of the rows masked) and a cotangent of the
    output's shape; returns the pad rows too."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    ms = rng.uniform(0.01, 0.05, size=(rows, 1))
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    return (t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb),
            torch.tensor(ms, dtype=torch.float32, device=cuda),
            t(rows // conv.group, conv.d_out), torch.tensor(pad, device=cuda))


def _assert_terms_match(terms, default, args, mlp_ws, si2_ws):
    """The terms kernels against the plain version and against the default
    kernels; pad rows of the gradients exactly zero."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    xg, sh, emb, ms, g, pad = args
    fc.reset_launch_counts()
    y_t = terms.forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_t = terms.backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_terms_fwd'] = want['fused_conv_terms_bwd'] = 1
    assert fc.launch_counts == want
    y_p = terms.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = terms.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    y_k = default.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_k = default.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert tuple(y_t.shape) == tuple(y_p.shape)
    assert torch.isfinite(y_t).all()
    for ref in (y_p, y_k):
        assert (y_t - ref).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b, c in zip(d_t, d_p, d_k):
        assert torch.isfinite(a).all()
        lim = 1e-4 * max(b.abs().max(), 1e-6)
        assert (a - b).abs().max() <= lim and (a - c).abs().max() <= lim
        assert a[pad].abs().max() == 0                   # pad rows: zeros


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('degree', [32, 36, 0])
def test_terms_kernels_match_plain_and_default(cuda, model, layer, degree):
    """agg_d = 32 (whole tiles), 36 (a ragged last tile per atom) and 0
    (edge rows, 301 of them: a ragged last block); layer 0 has output
    columns no si2 path feeds."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    cl = model.layers[f'{layer}_convolution']
    terms = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree, cg_mode='terms')
    default = FusedConv(cl.tp, cl.weight_nn, cl.si2, degree)
    rows = 37 * degree if degree else 301
    _assert_terms_match(terms, default,
                        _plain_inputs(terms, rows, cuda, 40 + layer),
                        *cl._weights())


@pytest.mark.parametrize('degree', [16, 0])
def test_terms_kernels_small_multiplicities(cuda, degree):
    """Multiplicity 4 (not a multiple of a warp) and l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 3, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    terms = FusedConv(tp, mlp, si2, degree, cg_mode='terms')
    default = FusedConv(tp, mlp, si2, degree)
    rng = np.random.default_rng(9)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32,
                            device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    rows = 11 * degree if degree else 77
    _assert_terms_match(terms, default, _plain_inputs(terms, rows, cuda, 5),
                        mlp_ws, si2_ws)


def test_terms_wrapper_routes_cuda_tensors_to_the_kernel(cuda, model):
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    cl = model.layers['1_convolution']
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, cg_mode='terms')
    xg, sh, emb, ms, _, _ = _plain_inputs(conv, 4 * 32, cuda, 0)
    xg.requires_grad_(True)
    fc.reset_launch_counts()
    conv(xg, sh, emb, ms, *cl._weights()).sum().backward()
    want = dict.fromkeys(fc.launch_counts, 0)
    want['fused_conv_terms_fwd'] = want['fused_conv_terms_bwd'] = 1
    assert fc.launch_counts == want and xg.grad is not None


# -- the redesigned backwards: terms (row 4) and external-weight (row 8) ----

def _small_layer(cuda, seed, x='4x0e+4x1o+4x2e+4x3o',
                 sh='1x0e+1x1o+1x2e+1x3o', lmax=3, act='silu', out=None):
    """Specs and weights of a layer with multiplicities under 32 and, by
    default, 16 SH components; si2 maps onto ``out`` (default x)."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)
    x, sh = Irreps(x), Irreps(sh)
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, lmax, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), act)
    si2 = LinearSpec(tp.irreps_out, Irreps(out) if out else x)
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape) * 0.5,
                            dtype=torch.float32, device=cuda)

    mlp_ws = tuple(t(*s) for s in mlp.param_shapes().values())
    si2_ws = tuple(t(*si2.param_shapes()[f'w{n}'])
                   for n in range(len(si2.paths)))
    return tp, mlp, si2, mlp_ws, si2_ws


def _layer_specs(model, which, cuda):
    if which == 'small':
        return _small_layer(cuda, 3)
    if which == 'tanh':
        return _small_layer(cuda, 4, '8x0e+8x1o', '1x0e+1x1o', 1, 'tanh')
    if which == 'ssp':
        return _small_layer(cuda, 5, '32x0e+16x1e', '1x0e+1x1o+1x2e', 2,
                            'ssp')
    if which == 'odd':          # multiplicities not a multiple of 4
        return _small_layer(cuda, 7, '3x0e+5x1o', '1x0e+1x1o', 1)
    cl = model.layers[f'{which[-1]}_convolution']
    return (cl.tp, cl.weight_nn, cl.si2, *cl._weights())


def _pad_atoms(ms, group, atoms=(1, 4)):
    """Rows of whole atoms (or tiles) made pads."""
    for a in atoms:
        ms[a * group:(a + 1) * group] = 0.0
    return ms


@pytest.mark.parametrize('which,degree', [
    ('layer1', 32), ('layer1', 20), ('layer1', 40), ('layer0', 32),
    ('layer4', 24), ('small', 16), ('small', 0), ('tanh', 12), ('tanh', 0),
    ('ssp', 32), ('ssp', 0), ('layer1', 0), ('layer0', 0)])
def test_terms_backward_edges_of_the_tiling(cuda, model, which, degree):
    """The redesigned terms backward against its plain version where the
    tiling has edges: D not a multiple of the 16-row tile (20, 40, 24, 12),
    atoms (and at agg_d = 0 tiles) of pad rows only, multiplicities under 32,
    16 SH components (lmax 3), tanh and ssp; pad rows exactly zero and two
    launches bit-equal."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    tp, mlp, si2, mlp_ws, si2_ws = _layer_specs(model, which, cuda)
    conv = FusedConv(tp, mlp, si2, degree, cg_mode='terms')
    assert conv.kernel_refusal is None
    rows = 13 * degree if degree else 301
    xg, sh, emb, ms, g, _ = _plain_inputs(conv, rows, cuda, 11)
    ms = _pad_atoms(ms, degree or 8)
    pad = (ms == 0).reshape(-1)
    d_k = conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    d_2 = conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = conv.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    for a, b, c in zip(d_k, d_p, d_2):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad].abs().max() == 0
        assert torch.equal(a, c)


@pytest.mark.parametrize('which,degree', [
    ('layer1', 32), ('layer1', 20), ('layer1', 40), ('layer0', 32),
    ('layer4', 24), ('small', 16), ('x16', 12), ('ssp', 32)])
def test_extw_backward_edges_of_the_tiling(cuda, model, which, degree):
    """The redesigned external-weight backward against its plain version:
    D not a multiple of the tile, atoms of pad rows only, multiplicities
    under 32, 16 SH components, 16 x entries (over the dense pair's class
    table), dead weight columns (layer 0) as zeros; two launches bit-equal."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    if which == 'x16':
        # si2 onto one entry an irrep: the kernels' tables take one si2
        # path per input entry (ROADMAP C)
        spec = _small_layer(cuda, 6, '+'.join(['2x0e', '2x1o'] * 8),
                            '1x0e+1x1o', 1, out='16x0e+16x1o')
    else:
        spec = _layer_specs(model, which, cuda)
    tp, mlp, si2, mlp_ws, si2_ws = spec
    conv = FusedConv(tp, mlp, si2, degree, ext_w=True)
    assert conv.kernel_refusal is None
    xg, sh, weff, g, pad = _extw_inputs(conv, 13, degree, cuda, 21, mlp_ws)
    for a in (1, 4):
        weff[a * degree:(a + 1) * degree] = 0.0
        pad[a * degree:(a + 1) * degree] = True
    d_k = conv.kernel_extw_backward(g, xg, sh, weff, si2_ws)
    d_2 = conv.kernel_extw_backward(g, xg, sh, weff, si2_ws)
    d_p = conv.plain_extw_backward(g, xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    for a, b, c in zip(d_k, d_p, d_2):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)
        assert a[pad].abs().max() == 0
        assert torch.equal(a, c)
    t = conv.kernel_tables(xg.device)
    if t.n_dead:
        assert d_k[2][:, t.dead_w.long()].abs().max() == 0


def test_redesigned_backwards_resources(cuda, model):
    """No local memory; the checkpoint's mid layer at two blocks an SM:
    the terms backward both forms, the external-weight backward."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    cl = model.layers['1_convolution']
    for dd in (32, 0):
        conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, dd, cg_mode='terms')
        regs, local, per_sm = conv._terms.bwd_resources(dd)
        assert local == 0 and per_sm >= 2 and regs <= 128, (dd, regs)
    conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, ext_w=True)
    regs, local, per_sm, smem = conv.extw_resources(cuda)
    d = fcg.extw_dims(conv)
    assert local == 0 and per_sm >= 2
    assert smem == 4 * fcg.extw_words(d, fcg.extw_tile(d))


@pytest.mark.parametrize('lib', ['fused_conv_terms', 'fused_conv_geom_extw'])
def test_redesigned_backwards_sass_no_local_memory(cuda, lib):
    """Every instance of the terms pair (both forms, both ways) and of the
    external-weight pair (the backward at 4, 9, 16 SH, the forward): FFMA
    on the CUDA cores, no tensor-core opcode, no LDL / STL."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count(lib)
    assert len(counts) == 4
    assert sum('fwd' in k for k in counts) == (2 if 'terms' in lib else 1)
    for k, v in counts.items():
        assert v['FFMA'] > 0, k
        for op in (*sass_compare.TENSOR_CORE_OPS, *sass_compare.LOCAL_OPS):
            assert v[op] == 0, (k, op, v[op])


# SASS digests of the external-weight backward's instances (4, 9, 16 SH) as
# redesigned, before the external-weight forward joined their build
PARENT_EXTW_BWD_SASS = {'4': 'd8cf526f5ab8', '9': '9fa855366a9d',
                        '16': '5455282fa6b2'}


def test_extw_backward_keeps_its_sass(cuda):
    """The external-weight forward joined the build fused_conv_geom_extw
    behind the preprocessor gate: the backward's three instances keep the
    SASS of their redesign."""
    import re
    from sevennet_exp_tpu_torch.tools import sass_compare
    got = {re.search(r'ILi(\d+)E', k).group(1): v for k, v in
           sass_compare.digests('fused_conv_geom_extw').items()
           if 'extw_bwd' in k}
    assert got == PARENT_EXTW_BWD_SASS


# -- the redesigned forwards: terms (row 3) and external-weight (row 7) -----

@pytest.mark.parametrize('which,degree', [
    ('layer1', 32), ('layer1', 20), ('layer1', 40), ('layer0', 32),
    ('layer4', 24), ('small', 16), ('small', 0), ('tanh', 12), ('tanh', 0),
    ('ssp', 32), ('ssp', 0), ('layer1', 0), ('layer0', 0), ('layer4', 0),
    ('odd', 8), ('odd', 0)])
def test_terms_forward_edges_of_the_tiling(cuda, model, which, degree):
    """The redesigned terms forward against its plain version where the
    tiling has edges: D not a multiple of the 16-row tile (20, 40, 24, 12),
    row counts not a multiple of the tile at agg_d = 0 (301), atoms (and
    tiles) of pad rows only, multiplicities under 32, f = 4 (tanh), 9 (ssp)
    and 16 (small, lmax 3); pad rows' outputs exactly zero at agg_d = 0 and
    two launches bit-equal."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    tp, mlp, si2, mlp_ws, si2_ws = _layer_specs(model, which, cuda)
    conv = FusedConv(tp, mlp, si2, degree, cg_mode='terms')
    assert conv.kernel_refusal is None
    rows = 13 * degree if degree else 301
    xg, sh, emb, ms, _, _ = _plain_inputs(conv, rows, cuda, 12)
    ms = _pad_atoms(ms, degree or 16)
    y_k = conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    y_2 = conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert torch.isfinite(y_k).all() and torch.equal(y_k, y_2)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    if degree == 0:
        assert y_k[(ms == 0).reshape(-1)].abs().max() == 0
    else:
        for a in (1, 4):
            assert y_k[a].abs().max() == 0           # an atom of pads


@pytest.mark.parametrize('which,degree', [
    ('layer1', 32), ('layer1', 20), ('layer1', 40), ('layer0', 32),
    ('layer4', 24), ('small', 16), ('x16', 12), ('ssp', 32), ('tanh', 6),
    ('odd', 8)])
def test_extw_forward_edges_of_the_tiling(cuda, model, which, degree):
    """The redesigned external-weight forward against its plain version: D
    not a multiple of the tile, atoms of pad rows only, multiplicities
    under 32 and not a multiple of 4 (odd: weights read one column at a
    time), 16 SH components, 16 x entries, dead weight columns (layer 0);
    two launches bit-equal."""
    from sevennet_exp_tpu_torch.ops.fused_conv import FusedConv
    if which == 'x16':
        spec = _small_layer(cuda, 6, '+'.join(['2x0e', '2x1o'] * 8),
                            '1x0e+1x1o', 1, out='16x0e+16x1o')
    else:
        spec = _layer_specs(model, which, cuda)
    tp, mlp, si2, mlp_ws, si2_ws = spec
    conv = FusedConv(tp, mlp, si2, degree, ext_w=True)
    assert conv.kernel_refusal is None
    xg, sh, weff, _, _ = _extw_inputs(conv, 13, degree, cuda, 22, mlp_ws)
    for a in (1, 4):
        weff[a * degree:(a + 1) * degree] = 0.0
    y_k = conv.kernel_extw_forward(xg, sh, weff, si2_ws)
    y_2 = conv.kernel_extw_forward(xg, sh, weff, si2_ws)
    y_p = conv.plain_extw_forward(xg, sh, weff, si2_ws)
    torch.cuda.synchronize()
    assert torch.isfinite(y_k).all() and torch.equal(y_k, y_2)
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    assert y_k[1].abs().max() == 0 and y_k[4].abs().max() == 0


def test_redesigned_forwards_resources(cuda, model):
    """At most 128 registers, no local memory and at least two blocks an SM
    at every layer of the checkpoint: the terms forward both forms and the
    external-weight forward, at the shared bytes their plans give."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        for dd in (32, 0):
            conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, dd,
                                cg_mode='terms')
            regs, local, per_sm = conv._terms.fwd_resources(dd)
            assert local == 0 and per_sm >= 2 and regs <= 128, (li, dd)
        conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, 32, ext_w=True)
        regs, local, per_sm, smem = conv.extw_resources(cuda, fwd=True)
        d = fcg.extw_dims(conv)
        T, s = fcg.extw_fwd_shape(d)
        assert local == 0 and per_sm >= 2 and regs <= 128, li
        assert smem == 4 * fcg.extw_fwd_words(d, T, s)


def test_si2_fanout_layer_runs_plain_on_the_card(cuda):
    """Fault C.3: a layer whose si2 input entry feeds two output entries
    (si2 onto 2x0e+2x1o+2x0e) is refused by every kernel form, launches no
    conv kernel on the card and gives the CPU's output (1e-5 of its
    largest entry), under both CG modes."""
    from sevennet_exp_tpu_torch import _keys as KEY
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.model import layers as L
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, LinearSpec, UVUTensorProductSpec)
    x, sh = Irreps('4x0e+4x1o'), Irreps('1x0e+1x1o')
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 1, 'full'))
    layer = L.IrrepsConvolution(
        tp, FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu'),
        LinearSpec(tp.irreps_out, Irreps('2x0e+2x1o+2x0e')), 10.0)
    params, _ = layer.init(torch.Generator().manual_seed(3))
    for group, vals in ((layer.weight_nn_p, params['weight_nn']),
                        (layer.si2_p, params['si2'])):
        for k, v in vals.items():
            getattr(group, k).copy_(v)
    for dd in (0, 16):
        for kw in ({}, {'cg_mode': 'terms'}, {'ext_w': True}):
            assert 'feeds 2 output entries' in layer.kernel_refusal(dd, **kw)
    rng = np.random.default_rng(4)
    n, e = 9, 60
    data = {KEY.NODE_FEATURE: rng.normal(size=(n, x.dim)),
            KEY.EDGE_IDX: rng.integers(0, n, size=(2, e)),
            KEY.EDGE_ATTR: rng.normal(size=(e, sh.dim)),
            KEY.EDGE_EMBEDDING: rng.normal(size=(e, 8)),
            KEY.EDGE_MASK: rng.uniform(size=e) > 0.2}
    ref = layer(dict((k, torch.tensor(v, dtype=torch.long if k ==
                                      KEY.EDGE_IDX else torch.float32))
                     for k, v in data.items()))[KEY.NODE_FEATURE]
    layer.to(cuda)
    for mode in ('cmshared', 'terms'):
        dev_data = {k: torch.tensor(v, device=cuda, dtype=torch.long if k ==
                                    KEY.EDGE_IDX else torch.float32)
                    for k, v in data.items()}
        dev_data[fc.CG_MODE_KEY] = mode
        fc.reset_launch_counts()
        out = layer(dev_data)[KEY.NODE_FEATURE]
        torch.cuda.synchronize()
        assert not any(fc.launch_counts.values()), mode
        assert (out.cpu() - ref).abs().max() <= 1e-5 * ref.abs().max()


def test_engine_with_terms_matches_default_on_the_card(cuda, model):
    """E, F and stress of a 64-atom NPT engine: terms kernels against the
    default kernels, whole-array and in chunks of 24 atoms."""
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(64, rattle=0.1, seed=1)
    kw = dict(device=cuda, ensemble='npt', pressure_gpa=1.0)
    md = MolecularDynamics(model, at, **kw)
    nl = md._grid()
    e0, f0, s0 = md._efs_fn(md.state.pos, nl, md.state.cell)
    for chunk in (0, 24):
        mdt = MolecularDynamics(model, at, cg_mode='terms',
                                conv_chunk_atoms=chunk, **kw)
        fc.reset_launch_counts()
        e, f, s = mdt._efs_fn(md.state.pos, nl, md.state.cell)
        n_chunks = 3 if chunk else 1
        assert fc.launch_counts['fused_conv_terms_fwd'] == 5 * n_chunks
        assert fc.launch_counts['fused_conv_terms_bwd'] == 5 * n_chunks
        assert fc.launch_counts['fused_conv_fwd'] == 0
        assert abs(float(e) - float(e0)) <= 1e-4
        assert (f - f0).abs().max() <= 1e-4
        assert (s - s0).abs().max() <= 1e-6


def test_chunked_plain_chain_on_the_card(cuda, model):
    """Fault C.4: a 1k force call in chunks of 96 atoms with
    use_kernels=False (every chunk on the plain chain, checkpointed)
    launches no kernel and equals the kernel path within 1e-3 eV/A and
    1e-5 eV/atom."""
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(1000)
    md = MolecularDynamics(model, at, device=cuda)
    nl = md._grid()
    e0, f0 = md._ef_fn(md.state.pos, nl)
    mdp = MolecularDynamics(model, at, device=cuda, use_kernels=False,
                            conv_chunk_atoms=96)
    assert mdp.n % 96 and mdp.conv_chunk_rows == 96 * md.deg_cap
    fc.reset_launch_counts()
    e, f = mdp._ef_fn(md.state.pos, nl)
    torch.cuda.synchronize()
    assert not any(fc.launch_counts.values())
    assert (f - f0).abs().max() <= 1e-3
    assert abs(float(e) - float(e0)) / md.n <= 1e-5


# -- the bare tensor product ---------------------------------------------------

def _tp_inputs(op, rows, cuda, seed):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.normal(size=(rows, d)), dtype=torch.float32,
                         device=cuda)
            for d in (op.d1, op.f, op.w_numel, op.d3)]


def _unaligned(t):
    """A contiguous copy of T that starts 4 bytes past a 16-byte line."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.is_contiguous() and out.data_ptr() % 16 == 4
    return out


def _assert_tp_matches_plain(op, rows, cuda, seed):
    from sevennet_exp_tpu_torch.ops import fused_tp as ftp
    xg, sh, w, g = _tp_inputs(op, rows, cuda, seed)
    names = ('fused_tp_fwd', 'fused_tp_bwd', 'fused_tp_bwd_table')
    for k in names:
        ftp.launch_counts[k] = 0
    xs = [t.clone().requires_grad_(True) for t in (xg, sh, w)]
    out = op(*xs)                               # through autograd
    grads = torch.autograd.grad(out, xs, g)
    bwd = 'fused_tp_bwd' if op.bwd_route == 'steps' else 'fused_tp_bwd_table'
    assert {k: ftp.launch_counts[k] for k in names} == {
        k: int(k in ('fused_tp_fwd', bwd)) for k in names}
    ref = op.plain_forward(xg, sh, w)
    ref_grads = op.plain_backward(g, xg, sh, w)
    torch.cuda.synchronize()
    assert tuple(out.shape) == (rows, op.d3)
    assert (out - ref).abs().max() <= 1e-4 * ref.abs().max()
    for a, b in zip(grads, ref_grads):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


@pytest.mark.parametrize('layer', [0, 1, 4])
@pytest.mark.parametrize('rows', [256, 301])
def test_fused_tp_kernels_match_plain(cuda, model, layer, rows):
    """301 rows: a ragged last block (8 rows per block)."""
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    op = make_fused_tp(model.layers[f'{layer}_convolution'].tp)
    _assert_tp_matches_plain(op, rows, cuda, 60 + layer)


def test_fused_tp_kernels_small_multiplicities(cuda):
    """Multiplicity 4 (not a multiple of a warp), l up to 3."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    from sevennet_exp_tpu_torch.ops.tensor_product import UVUTensorProductSpec
    x = Irreps('4x0e+4x1o+4x2e+4x3o')
    sh = Irreps('1x0e+1x1o+1x2e+1x3o')
    op = make_fused_tp(UVUTensorProductSpec(
        x, sh, infer_irreps_out(x, sh, 3, 'full')))
    _assert_tp_matches_plain(op, 77, cuda, 3)


@pytest.mark.parametrize('layer', [0, 1, 4])
def test_fused_tp_backward_ragged_over_its_persistent_grid(cuda, model, layer):
    """10,007 rows: a prime, so the warps of the persistent grid (one row
    at a time, rows warp, warp + all warps, ...) end on different rows and
    the last rows fall in no whole block of 8."""
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    op = make_fused_tp(model.layers[f'{layer}_convolution'].tp)
    _assert_tp_matches_plain(op, 10007, cuda, 70 + layer)


# (x, sh, lmax) of specs beside the checkpoint's (tests/test_torch_fused_tp.py
# holds their tables): the step backward at multiplicity 6 (single-channel
# copies), with sh entries off l^2 and out of order; the table-driven
# backward at an l of 4, an sh entry of multiplicity 2, two sh entries of
# one l
OTHER_TP_SPECS = {
    'mul6': ('6x0e+6x1o+6x2e', '1x0e+1x1o+1x2e', 2, 'steps'),
    'sh02': ('4x0e+4x1o+4x2e', '1x0e+1x2e', 2, 'steps'),
    'sh10': ('4x0e+4x1o', '1x1o+1x0e', 1, 'steps'),
    'l4': ('4x0e+4x4e', '1x0e+1x4e', 4, 'table'),
    'sh_mul2': ('4x0e+4x1o', '2x0e+1x1o', 1, 'table'),
    'dup_l': ('4x0e+4x1o', '1x1o+1x1e', 1, 'table'),
}


@pytest.mark.parametrize('which', list(OTHER_TP_SPECS))
def test_fused_tp_backward_takes_every_spec(cuda, which):
    """No spec is refused: the step kernel takes multiplicities that are
    not multiples of 4 and sh entries anywhere, the table-driven body the
    rest; each held to the plain version."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.fused_tp import make_fused_tp
    from sevennet_exp_tpu_torch.ops.tensor_product import UVUTensorProductSpec
    x, sh, lmax, route = OTHER_TP_SPECS[which]
    x, sh = Irreps(x), Irreps(sh)
    op = make_fused_tp(UVUTensorProductSpec(
        x, sh, infer_irreps_out(x, sh, lmax, 'full')))
    assert op.bwd_route == route
    _assert_tp_matches_plain(op, 301, cuda, 90)


@pytest.mark.parametrize('layer', [1, 4])
def test_fused_tp_backward_takes_unaligned_rows(cuda, model, layer):
    """g, xg and w 4 bytes past a 16-byte line: the launch copies single
    channels, and gives the aligned launch's bits."""
    from sevennet_exp_tpu_torch.ops import fused_tp as ftp
    op = ftp.make_fused_tp(model.layers[f'{layer}_convolution'].tp)
    xg, sh, w, g = _tp_inputs(op, 301, cuda, 80 + layer)
    ref = op.kernel_backward(g, xg, sh, w)
    before = ftp.launch_counts['fused_tp_bwd']
    got = op.kernel_backward(*map(_unaligned, (g, xg)), sh, _unaligned(w))
    assert ftp.launch_counts['fused_tp_bwd'] == before + 1
    plain = op.plain_backward(g, xg, sh, w)
    torch.cuda.synchronize()
    for a, b, c in zip(got, ref, plain):
        assert torch.equal(a, b)
        assert (a - c).abs().max() <= 1e-4 * max(c.abs().max(), 1e-6)


def test_fused_tp_backward_sass_no_local_memory(cuda):
    """Every instance of the redesigned backward (16 with 16-byte copies,
    16 with 4-byte ones): fp32 on the CUDA cores, nothing in local
    memory."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = {k: v for k, v in sass_compare.count('fused_tp').items()
              if 'fused_tp_bwd_kernel' in k}
    assert len(counts) == 32, list(counts)
    for k, c in counts.items():
        assert c['FFMA'] > 0, k
        assert not any(c[op] for op in (*sass_compare.LOCAL_OPS,
                                         *sass_compare.TENSOR_CORE_OPS)), k


# SASS digests of the kernels beside the redesigned bare-TP backward and
# layout transpose, as they were before them: the bare TP's forward (row
# 9), the terms pair (rows 3-4), bench_layout's row- and col-major kernels
# (chip_smoke.py holds them too)
PARENT_UNTOUCHED_SASS = {
    'fused_tp': ('fused_tp_fwd_kernel', ('f27695869423',)),
    'fused_conv_terms': ('terms_', ('58069b73147a', '90e5aa393ecc',
                                    'caa01d830e0d', 'dc6feb1dee3b')),
    'bench_layout': ('layout_', ('e39d08c7e3a2', '251bf32cd9a4')),
}


def test_kernels_beside_the_tp_and_transpose_redesigns_keep_their_sass(cuda):
    from sevennet_exp_tpu_torch.tools import sass_compare
    for name, (stem, want) in PARENT_UNTOUCHED_SASS.items():
        got = sorted(v for k, v in sass_compare.digests(name).items()
                     if stem in k and 'transpose' not in k)
        assert got == sorted(want), name


# -- the micro-benchmark kernels (tools/bench_*.py) ----------------------

@pytest.mark.parametrize('pads', [False, True], ids=['ms1', 'pads'])
@pytest.mark.parametrize('variant', ['full', '-mlp', '-cg', '-w', '-agg',
                                     '-si2'])
def test_bench_pieces_kernels_match_plain(cuda, variant, pads):
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_pieces as bp
    conv = bp.mid_layer_conv()
    xg, sh, emb, ms, mlp_ws, si2_ws = bp.make_inputs(conv, 9 * 32, cuda)
    if pads:
        ms[torch.rand(ms.shape[0], device=cuda) < 0.2] = 0.0
    ins = (xg, sh, emb, ms, mlp_ws, si2_ws)
    before = cuda_build.launch_counts[bp.COUNTER[variant]]
    got = bp.variant_forward(conv, variant, *ins)
    assert cuda_build.launch_counts[bp.COUNTER[variant]] == before + 1
    ref = bp.plain_variant(conv, variant, *ins)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if variant in ('full', '-agg'):
        # the production kernel itself, launched as the model launches it:
        # the same bits
        other = bp.edge_conv(conv) if variant == '-agg' else conv
        assert torch.equal(got, other.kernel_forward(*ins))


def test_bench_pieces_full_and_agg_are_kernel_1_and_its_edge_form(cuda):
    """bench_pieces full is kernel 1 and -agg the edge-row kernel 1: the
    SASS digests of the default build's dense and edge forwards."""
    got = _pieces_digests()
    assert got['full'] == PARENT_DENSE_SASS['fwd']
    assert got['-agg'] == PARENT_EDGE_SASS['fwd']


@pytest.mark.parametrize('mode', ['st', 'outer', 'dots'])
@pytest.mark.parametrize('i1', [1, 2])
def test_bench_cgmxu_kernels_match_plain(cuda, i1, mode):
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    cls = bc.cg_class(i1)
    ins = bc.make_inputs(cls, 320, cuda)
    got = bc.forward(cls, mode, *ins)
    ref = bc.plain(cls, mode, *ins)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if mode != 'dots':
        orc = torch.tensor(bc.oracle(cls, *ins, 64), device=cuda)
        assert (got[:, :64] - orc).abs().max() <= 1e-4 * orc.abs().max()


def test_bench_cgmxu_dots_sass_has_every_multiply_add(cuda):
    """Each dots instance issues at least d3tot K FFMA per column it owns
    (4 edges a thread): the dense product is neither folded nor cut."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_cgmxu')
    for K, d3 in bc.DOTS_SHAPES:
        (c,) = [v for k, v in counts.items()
                if f'cgmxu_dots_kernelILi{K}ELi{d3}E' in k]
        assert c['FFMA'] >= d3 * K * bc.DOTS_EDGES


@pytest.mark.parametrize('i1', [0, 1, 2])
def test_bench_cgmxu_outer_matches_plain_on_ragged_edges(cuda, i1):
    """The outer kernel at E = 32 x 37 (a multiple of 32, not of 128: the
    last block's threads past E own no edges) against its plain version."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    cls = bc.cg_class(i1)
    ins = bc.make_inputs(cls, 32 * 37, cuda, seed=i1)
    got = bc.forward(cls, 'outer', *ins)
    ref = bc.plain(cls, 'outer', *ins)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_bench_cgmxu_outer_sass_has_every_multiply_add(cuda):
    """Each outer instance issues at least d3tot d1 f FFMA per column it
    owns (4 edges a thread): the dense product, C's zeros included, is
    neither folded nor cut; and nothing goes to local memory."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_cgmxu')
    for d1, f, d3 in bc.OUTER_SHAPES:
        (c,) = [v for k, v in counts.items()
                if f'cgmxu_outer_kernelILi{d1}ELi{f}ELi{d3}E' in k]
        assert c['FFMA'] >= d1 * f * d3 * bc.DOTS_EDGES
        assert not any(c[op] for op in sass_compare.LOCAL_OPS)


# SASS digests of the micro-benchmark kernels that the redesigns of the
# bf16 dot, the outer and st CG, bench_cg's c and bench_tile's b and c left
# alone, as they were before them, by kernel-name stem (chip_smoke.py holds
# them too)
PARENT_MICRO_SASS = {
    'bench_dot': ('4539c5e9a7f6', '43900b2b462c', 'cffb86f3b49f',
                  '40053fb204ef', 'e6250dfce0f8', 'e61ab816330d',
                  '24ccc4e63ba3', '24a040861ee6', '20ebae4a7d96',
                  '5d330983afe7', '2cde1487ece9'),
    'bench_cgmxu': ('5e3d3e051d91', '40b05ac7fb83', '73a9cda46545'),
    'bench_cg': ('a450a1e2efb4', '09bc131a86bb'),
    'bench_tile': ('93cfa8d49dbf', '08b3263bc8c0'),
}
MICRO_SASS_STEMS = {'bench_dot': ('dot_fp32_',),
                    'bench_cgmxu': ('cgmxu_dots_',),
                    'bench_cg': ('cg_a_', 'cg_b_'),
                    'bench_tile': ('tile_d_kernel', 'tile_a_kernel')}


def test_untouched_micro_kernels_keep_their_sass(cuda):
    """The fp32 bench_dot kernels, the dots kernels of bench_cgmxu,
    bench_cg's a and b and bench_tile's d and a compile to the SASS they
    had before the kernels beside them (bf16, outer, st, bench_cg's c,
    bench_tile's b and c) were redesigned."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    for name, stems in MICRO_SASS_STEMS.items():
        got = sorted(v for k, v in sass_compare.digests(name).items()
                     if any(stem in k for stem in stems))
        assert got == sorted(PARENT_MICRO_SASS[name])


@pytest.mark.parametrize('E', [32768, 32 * 37])
@pytest.mark.parametrize('i1', [0, 1, 2])
def test_bench_cgmxu_st_matches_plain(cuda, i1, E):
    """The st kernel at the tool's E and at E = 32 x 37 (a multiple of 32,
    not of 128: the last block's threads past E own no edges)."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    cls = bc.cg_class(i1)
    ins = bc.make_inputs(cls, E, cuda, seed=i1)
    got = bc.forward(cls, 'st', *ins)
    ref = bc.plain(cls, 'st', *ins)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


def test_bench_cgmxu_st_sass_has_every_multiply(cuda):
    """Each st instance issues every multiply of its dense tables and of
    the products with x per column it owns (4 edges a thread; the first of
    each sum an FMUL), and nothing goes to local memory."""
    from sevennet_exp_tpu_torch.tools import bench_cgmxu as bc
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_cgmxu')
    for (d1, f, d3), ins in bc.ST_CLASSES.items():
        (c,) = [v for k, v in counts.items()
                if f'cgmxu_st_kernelILi{d1}ELi{f}ELi{d3}E' in k]
        want = bc.DOTS_EDGES * sum(d3k * d1 * (d2 + 1) for _, d2, d3k in ins)
        assert c['FFMA'] + c['FMUL'] >= want
        assert not any(c[op] for op in sass_compare.LOCAL_OPS)


@pytest.mark.parametrize('shape', [(27, 20, 384), (45, 22, 384),
                                   (27, 22, 384), (45, 20, 384),
                                   (8, 128, 384)])
def test_bench_dot_bf16_ragged_shapes(cuda, shape):
    """The bf16 kernel on CG-sized K and M that fill no k16 step or M16
    strip (K = 27, 45; M = 20, 22; K = 8 with all 128 rows of M), N = 3 x
    128 (the last N tile of two warps' width is half), G = 3 slices,
    against the fp32 product of the rounded inputs."""
    from sevennet_exp_tpu_torch.tools import bench_dot as bd
    K, M, N = shape
    C, Z = bd.make_inputs(K, M, N, cuda, g=3, seed=K + M)
    got = bd.forward('bf16', C, Z)
    ref = bd.plain('bf16', C, Z)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-5 * K * ref.abs().max()
    assert torch.isfinite(got).all()


@pytest.mark.parametrize('dtype', ['fp32', 'bf16'])
@pytest.mark.parametrize('shape', [(27, 20, 256), (45, 22, 128),
                                   (128, 128, 256), (8, 128, 128),
                                   (128, 8, 384), (1, 1, 128),
                                   (33, 17, 384), (64, 64, 256),
                                   (127, 129, 256)])
def test_bench_dot_kernels_match_plain(cuda, shape, dtype):
    from sevennet_exp_tpu_torch.tools import bench_dot as bd
    K, M, N = shape
    C, Z = bd.make_inputs(K, M, N, cuda, g=3)
    got = bd.forward(dtype, C, Z)
    ref = bd.plain(dtype, C, Z)
    torch.cuda.synchronize()
    lim = (1e-4 if dtype == 'fp32' else 1e-5 * K) * ref.abs().max()
    assert (got - ref).abs().max() <= lim
    if dtype == 'bf16':      # the rounding of the inputs shows
        assert (got - bd.plain('fp32', C, Z)).abs().max() > lim


def test_bench_dot_fp32_has_no_tensor_core_op(cuda):
    """The fp32 kernels multiply on the CUDA cores: FFMA, no HMMA (bf16's
    kernels, the check's control, have their mma.sync, and nothing in local
    memory)."""
    from sevennet_exp_tpu_torch.tools import bench_dot as bd
    from sevennet_exp_tpu_torch.tools import sass_compare
    counts = sass_compare.count('bench_dot')
    fp32 = {k: v for k, v in counts.items() if 'dot_fp32_' in k}
    assert len(fp32) == (len(bd.STREAM_TMS) + len(bd.STREAM_TMS_CW8)
                         + 1)        # the stream instances and the tile
    for v in fp32.values():
        assert v['FFMA'] > 0
        assert not any(v[op] for op in sass_compare.TENSOR_CORE_OPS)
    bf16 = [v for k, v in counts.items() if 'dot_bf16_kernel' in k]
    assert len(bf16) == 2 * len(bd.BF16_KS)
    for v in bf16:
        assert v['HMMA'] > 0
        assert not any(v[op] for op in sass_compare.LOCAL_OPS)


@pytest.mark.parametrize('variant', ['a:per-term', 'b:3d-reshape',
                                     'c:full-width'])
def test_bench_cg_kernels_match_plain(cuda, variant):
    from sevennet_exp_tpu_torch.tools import bench_cg
    x, y = bench_cg.make_inputs(100, cuda)     # a ragged last block
    got = bench_cg.forward(variant, x, y)
    ref = bench_cg.plain(variant, x, y)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


@pytest.mark.parametrize('E', [32768, 1003, 7])
def test_bench_cg_c_matches_plain_and_a(cuda, E):
    """c on the tensor cores at the tool's E and on ragged ones (a part
    full last 16-row tile; fewer rows than one tile): within 1e-4 of its
    max|plain| of the plain version, and within 1e-4 of a."""
    from sevennet_exp_tpu_torch.tools import bench_cg
    x, y = bench_cg.make_inputs(E, cuda, seed=E)
    got = bench_cg.forward('c:full-width', x, y)
    ref = bench_cg.plain('c:full-width', x, y)
    a = bench_cg.plain('a:per-term', x, y)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (got - a).abs().max() < bench_cg.CROSS_TOL


def test_bench_cg_c_sass_runs_tf32_mma(cuda):
    """c's tiling product is HMMA.1688.F32.TF32 (mma.sync m16n8k8, TF32
    inputs, fp32 sums), and nothing goes to local memory."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    ((counts, _, texts),) = sass_compare.count_and_digests(
        ('bench_cg',), texts=True).values()
    (name,) = [k for k in counts if 'cg_c_kernel' in k]
    assert texts[name].count('HMMA.1688.F32.TF32') >= 50
    assert not any(counts[name][op] for op in sass_compare.LOCAL_OPS)


@pytest.mark.parametrize('variant', ['rowmajor', 'colmajor', 'transpose'])
def test_bench_layout_kernels_match_plain(cuda, variant):
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_layout as bl
    x, y = bl.make_inputs(cuda, grid=3)
    xv, yv = bl.inputs_for(variant, x, y)
    before = cuda_build.launch_counts[bl.COUNTER[variant]]
    got = bl.forward(variant, xv, yv)
    assert cuda_build.launch_counts[bl.COUNTER[variant]] == before + 1
    ref = bl.plain(variant, xv, yv)
    torch.cuda.synchronize()
    assert got.shape == ref.shape
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    if variant == 'rowmajor':        # a ragged last block of 8 rows
        part = bl.forward(variant, x[:100].contiguous(), y[:100].contiguous())
        assert torch.equal(part, got[:100])
    if variant == 'transpose':       # the same passes in the same order
        assert torch.equal(got, bl.forward('rowmajor', x, y))


def test_bench_layout_transpose_ragged_over_its_persistent_grid(cuda):
    """E = 32 x 133: more 32-row tiles than the grid's blocks (one an SM),
    so the blocks walk different numbers of tiles."""
    from sevennet_exp_tpu_torch.tools import bench_layout as bl
    n = 32 * 133
    x, y = bl.make_inputs(cuda, grid=17)
    x, y = x[:n].contiguous(), y[:n].contiguous()
    got = bl.forward('transpose', x, y)
    ref = bl.plain('transpose', x, y)
    torch.cuda.synchronize()
    assert got.shape == (n, bl.MUL)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert torch.equal(got, bl.forward('rowmajor', x, y))


def test_bench_layout_transpose_takes_unaligned_inputs(cuda):
    """x and y 4 bytes past a 16-byte line: the launch copies single
    floats, and gives the row-major kernel's bits."""
    from sevennet_exp_tpu_torch.tools import bench_layout as bl
    x, y = bl.make_inputs(cuda, grid=3)
    got = bl.forward('transpose', _unaligned(x), _unaligned(y))
    torch.cuda.synchronize()
    assert torch.equal(got, bl.forward('rowmajor', x, y))


def test_bench_layout_transpose_sass(cuda):
    """Every multiply-add of the 384 passes is issued, nothing is in local
    memory."""
    from sevennet_exp_tpu_torch.tools import bench_layout as bl
    from sevennet_exp_tpu_torch.tools import sass_compare
    (c,) = [v for k, v in sass_compare.count('bench_layout').items()
            if 'layout_transpose_kernel' in k]
    assert c['FFMA'] >= bl.R * bl.NSLICE
    assert not any(c[op] for op in sass_compare.LOCAL_OPS)


@pytest.mark.parametrize('E', [1, 7, 100, 1003, 32768 + 5])
@pytest.mark.parametrize('variant', ['d:per-slice', 'a:repeat',
                                     'b:bcast+cat', 'c:mxu-tile'])
def test_bench_tile_kernels_match_plain(cuda, variant, E):
    """Every row exactly once: fewer rows than b's and c's persistent
    grid has warps (1, 7, 100, 1003), a last block part full, and rows not
    a multiple of the grid's warps (32,773)."""
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bench_tile as bt
    x, s = bt.make_inputs(E, cuda, seed=E)
    before = cuda_build.launch_counts[bt.COUNTER[variant]]
    got = bt.forward(variant, x, s)
    assert cuda_build.launch_counts[bt.COUNTER[variant]] == before + 1
    ref = bt.plain(variant, x, s)
    torch.cuda.synchronize()
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()
    assert (got - bt.forward('d:per-slice', x, s)).abs().max() < 1e-3
    if variant == 'c:mxu-tile':      # T is read, not assumed
        T = torch.as_tensor(bt.ones_block(), device=cuda)
        T[1, 5] = -3.0
        got2 = bt.forward(variant, x, s, T)
        ref2 = bt.plain(variant, x, s, T)
        assert (got2 - ref2).abs().max() <= 1e-4 * ref2.abs().max()
        assert (got2 - got).abs().max() > 1e-3


def test_bench_tile_b_and_c_sass(cuda):
    """c issues every multiply-add of its tiling product and of the group
    sum (8 passes x (20 + 4) FFMA, the first product of each sum an FMUL);
    b stores each pass's whole tiled row and loads its 5 columns back
    (>= 8 x 20 bytes each way a lane and row, in any width); neither keeps
    anything in local memory."""
    from sevennet_exp_tpu_torch.tools import sass_compare
    from sevennet_exp_tpu_torch.tools.bench_tile import D1, REPS, W
    counts, _, texts = sass_compare.count_and_digests(
        ('bench_tile',), texts=True)['bench_tile']
    (c,) = [v for k, v in counts.items() if 'tile_c_kernel' in k]
    assert c['FFMA'] >= REPS * (D1 - 1) * (D1 + 1) == 192
    (b_name,) = [k for k in counts if 'tile_b_kernel' in k]
    shared = sass_compare.shared_bytes(texts[b_name])
    assert shared['STS'] >= REPS * W * 4 // 32 == 160
    assert shared['LDS'] >= REPS * D1 * 4 == 160
    for v in (c, counts[b_name]):
        assert not any(v[op] for op in sass_compare.LOCAL_OPS)


# -- refused layers and the shifted softplus ----------------------------------

def _tiny_config(**over):
    """A small 7net-0-style config (chemical species given, so no dataset
    statistics are needed)."""
    from sevennet_exp_tpu_torch.util import chemical_species_preprocess
    config = {
        'cutoff': 4.0, 'channel': 4,
        'radial_basis': {'radial_basis_name': 'bessel'},
        'cutoff_function': {'cutoff_function_name': 'poly_cut'},
        'lmax': 2, 'is_parity': True, 'num_convolution_layer': 2,
        'weight_nn_hidden_neurons': [64, 64], 'act_radial': 'silu',
        'conv_denominator': 30.0, 'self_connection_type': 'linear',
        'shift': -10.0, 'scale': 10.0,
    }
    config.update(chemical_species_preprocess(['Na', 'Cl']))
    config.update(over)
    return config


def _random_model(config, seed, device):
    from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
    from sevennet_exp_tpu_torch.model.model import flatten
    model = build_e3_equivariant_model(config)
    params, _ = model.init(torch.Generator().manual_seed(seed))
    model.load_state(flatten(params))
    return model.to(device)


@pytest.mark.parametrize('use_kernels', [True, False])
@pytest.mark.parametrize('hidden', [[32, 32], [64, 64]])
def test_refused_and_switched_off_layers_run_plain_on_the_card(
        cuda, hidden, use_kernels):
    """A model whose radial MLP the kernels refuse (hidden [32, 32]), and
    any model with use_kernels=False, runs the plain chain on the card:
    no conv kernel launches, and E/F match the CPU to 1e-4 eV, 1e-4 eV/A."""
    import copy
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    model = _random_model(_tiny_config(weight_nn_hidden_neurons=hidden), 3,
                          'cpu')
    plain = hidden != [64, 64] or not use_kernels
    routes = model.conv_routes(0, use_kernels=use_kernels)
    assert {r['route'] for r in routes} == {'plain' if plain else 'kernel'}
    at = build_nacl(64, rattle=0.1, seed=2)
    at.pos = at.pos * (3.4 / 5.63)
    at.cell = at.cell * (3.4 / 5.63)
    ref = SevenNetCalculator(copy.deepcopy(model), device='cpu',
                             use_kernels=use_kernels).calculate(at)
    fc.reset_launch_counts()
    res = SevenNetCalculator(model, device=cuda,
                             use_kernels=use_kernels).calculate(at)
    launched = sum(v for k, v in fc.launch_counts.items()
                   if k.startswith('fused_conv'))
    assert launched == (0 if plain else 4)
    assert abs(res['energy'] - ref['energy']) <= 1e-4
    assert np.abs(res['forces'] - ref['forces']).max() <= 1e-4


@pytest.mark.parametrize('mode', ['dense', 'edge', 'geom', 'terms16',
                                  'terms0'])
def test_ssp_kernels_match_plain(cuda, model, mode):
    """A radial MLP with the shifted softplus runs the kernels (activation
    code 2: the library fused_conv_geom_ssp, the terms pair's third
    branch) and matches the plain version to 1e-4 of its largest entry."""
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec)
    cl = model.layers['1_convolution']
    mlp = FullyConnectedNetSpec(cl.weight_nn.hs, 'ssp')
    degree = 0 if mode in ('edge', 'terms0') else 16
    conv = fc.FusedConv(cl.tp, mlp, cl.si2, degree,
                        geom=cl.geom if mode == 'geom' else None,
                        cg_mode='terms' if 'terms' in mode else 'cmshared')
    assert conv.kernel_refusal is None
    mlp_ws, si2_ws = cl._weights()
    fc.reset_launch_counts()
    if mode == 'geom':
        _assert_geom_kernels_match_plain(
            conv, _geom_inputs(conv, 11, 16, cuda, 5), mlp_ws, si2_ws)
        assert fc.launch_counts['fused_conv_geom_fwd'] == 1
        return
    xg, sh, emb, ms, g, pad = _plain_inputs(conv, 11 * 16, cuda, 6)
    y_k = conv.forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_k = conv.backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    assert sum(fc.launch_counts.values()) == 2
    y_p = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    d_p = conv.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    torch.cuda.synchronize()
    assert (y_k - y_p).abs().max() <= 1e-4 * y_p.abs().max()
    for a, b in zip(d_k, d_p):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max() <= 1e-4 * max(b.abs().max(), 1e-6)


def test_training_step_on_the_card_matches_cpu(cuda):
    """One loss and its gradients of the trainer on the card (plain chain,
    second order) against the CPU: loss to 1e-5 relative, each gradient
    leaf to 1e-4 of its largest entry; no conv kernel launches."""
    from sevennet_exp_tpu_torch.data.graph import (
        atoms_to_graph, build_nacl, collate_graphs)
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.train.trainer import Trainer
    config = _tiny_config(is_train_stress=True, loss='huber',
                          loss_param={'delta': 0.01}, force_loss_weight=25.0,
                          stress_loss_weight=0.01)
    rng = np.random.default_rng(0)
    graphs = []
    for seed in range(3):
        at = build_nacl(64, rattle=0.1, seed=seed)
        at.pos, at.cell = at.pos * (3.4 / 5.63), at.cell * (3.4 / 5.63)
        at.energy = float(rng.normal(-200, 1))
        at.forces = rng.normal(size=(64, 3))
        at.stress = rng.normal(size=6) * 1e-3
        graphs.append(atoms_to_graph(at, config['cutoff']))
    got = {}
    for dev in ('cpu', cuda):
        model = _random_model(config, 4, 'cpu')
        params, mask = model.init(torch.Generator().manual_seed(4))
        trainer = Trainer(model, params, mask, config, device=dev)
        fc.reset_launch_counts()
        got[str(dev)] = trainer.loss_and_grads(trainer.batch_to_device(
            collate_graphs(graphs)))
        assert sum(fc.launch_counts.values()) == 0
    (l_c, g_c), (l_g, g_g) = got['cpu'], got[str(cuda)]
    assert abs(float(l_g) - float(l_c)) <= 1e-5 * abs(float(l_c))
    for k in g_c:
        lim = 1e-4 * max(float(g_c[k].abs().max()), 1e-12)
        assert float((g_g[k].cpu() - g_c[k]).abs().max()) <= lim, k


# -- D3 and the model's other forms on the card ------------------------------

def test_d3_on_the_card_matches_cpu(cuda):
    """D3Calculator (plain PyTorch) on the card against the CPU, all four
    dampings on a periodic cell: E 1e-6 relative, F 1e-5 eV/A, stress 1e-6
    eV/A^3."""
    from sevennet_exp_tpu_torch.calculator import D3Calculator
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    at = build_nacl(64, rattle=0.1, seed=2)
    for damping in ('damp_zero', 'damp_bj', 'damp_zerom', 'damp_bjm'):
        kw = dict(damping=damping, rthr=1600.0, cn_thr=625.0)
        ref = D3Calculator(device='cpu', **kw).calculate(at)
        res = D3Calculator(**kw).calculate(at)
        assert res['energy'] == pytest.approx(ref['energy'], rel=1e-6)
        assert np.abs(res['forces'] - ref['forces']).max() <= 1e-5
        assert np.abs(res['stress'] - ref['stress']).max() <= 1e-6


def test_sevennet_d3_calculator_on_the_card(cuda, model):
    """The trained model plus D3 on the card (edge-row kernels 1-2, 5 + 5
    launches) against the CPU: 1e-4 eV, 1e-3 eV/A, 1e-5 eV/A^3."""
    import copy
    from sevennet_exp_tpu_torch.calculator import SevenNetD3Calculator
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(216, rattle=0.05, seed=3)
    ref = SevenNetD3Calculator(copy.deepcopy(model).cpu(), device='cpu',
                               rthr=1600.0).calculate(at)
    calc = SevenNetD3Calculator(model, rthr=1600.0)
    fc.reset_launch_counts()
    res = calc.calculate(at)
    assert {k: v for k, v in fc.launch_counts.items() if v} == {
        'fused_conv_edge_fwd': 5, 'fused_conv_edge_bwd': 5}
    assert abs(res['energy'] - ref['energy']) <= 1e-4
    assert np.abs(res['forces'] - ref['forces']).max() <= 1e-3
    assert np.abs(res['stress'] - ref['stress']).max() <= 1e-5


def test_engine_d3_replica_and_tiled_legs_agree_on_the_card(cuda, model):
    """The engine with d3= on the card: the whole-array leg (kernels 1-2,
    the replica sum) and the chunked leg (the geom pair, the tiled
    minimum-image sweep) give one force call's E/F within 1e-5 eV/atom and
    1e-3 eV/A; the whole-array leg matches the CPU engine."""
    import copy
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import d3 as d3mod
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    at = build_nacl(1000, rattle=0.05, seed=3)
    # 13 A: the 28 A cell holds the minimum image the chunked leg needs
    d3 = d3mod.D3Dispersion(rthr=600.0, cn_thr=400.0)
    kw = dict(ensemble='nvt', seed=0, d3=d3)
    whole = MolecularDynamics(model, at, **kw)
    chunked = MolecularDynamics(model, at, conv_chunk_atoms=96, **kw)
    assert not whole.conv_chunk_rows and chunked.conv_chunk_rows
    nl = whole._grid()
    fc.reset_launch_counts()
    e_w, f_w = whole._ef_fn(whole.state.pos, nl)
    assert fc.launch_counts['fused_conv_fwd'] == 5
    e_c, f_c = chunked._ef_fn(whole.state.pos, nl)
    assert fc.launch_counts['fused_conv_geom_fwd'] == 5 * -(-1000 // 96)
    assert abs(float(e_w) - float(e_c)) / 1000 <= 1e-5
    assert float((f_w - f_c).abs().max()) <= 1e-3
    cpu = MolecularDynamics(copy.deepcopy(model).cpu(), at, device='cpu',
                            ensemble='nvt', seed=0,
                            d3=d3mod.D3Dispersion(rthr=600.0, cn_thr=400.0,
                                                  device='cpu'))
    e_p, f_p = cpu._ef_fn(cpu.state.pos, cpu._grid())
    assert abs(float(e_w) - float(e_p)) / 1000 <= 1e-5
    assert float((f_w.cpu() - f_p).abs().max()) <= 1e-3


_VARIANTS = {
    'multi_cutoff': {'multi_cutoff': [5.0, 5.0, 4.5, 4.5, 4.0]},
    'modal': {'use_modality': True, 'use_modal_node_embedding': False,
              'use_modal_self_inter_intro': True,
              'use_modal_self_inter_outro': True,
              'use_modal_output_block': True, 'use_modal_wise_shift': True,
              'use_modal_wise_scale': False,
              '_modal_map': {'pbe': 0, 'scan': 1},
              '_number_of_modalities': 2},
    'fcn_readout': {'readout_as_fcn': True},
}


@pytest.mark.parametrize('name', list(_VARIANTS))
def test_variant_models_on_the_card(cuda, name):
    """trained_nacl's config with per-layer cutoffs, two modalities
    (multi_modal.yaml's flags) or the FCN readout, weights from a seed:
    the calculator on the card against the CPU (1e-4 eV, 1e-3 eV/A, 1e-5
    eV/A^3); multi-cutoff and FCN layers launch the edge-row kernels 1-2
    (the multi-cutoff engine's dense grid kernels 1-2, never the geom
    pair), the modal convolutions without si2 nothing."""
    import copy
    from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    config = dict(SevenNetCheckpoint(CKPT).config, **_VARIANTS[name])
    m_cpu = _random_model(config, 7, 'cpu')
    m = copy.deepcopy(m_cpu).to(cuda)
    modal = 'scan' if name == 'modal' else None
    at = build_nacl(216, rattle=0.05, seed=3)
    ref = SevenNetCalculator(m_cpu, device='cpu', modal=modal).calculate(at)
    fc.reset_launch_counts()
    res = SevenNetCalculator(m, modal=modal).calculate(at)
    launched = {k: v for k, v in fc.launch_counts.items() if v}
    assert launched == ({} if name == 'modal' else {
        'fused_conv_edge_fwd': 5, 'fused_conv_edge_bwd': 5})
    assert abs(res['energy'] - ref['energy']) <= 1e-4
    assert np.abs(res['forces'] - ref['forces']).max() <= 1e-3
    assert np.abs(res['stress'] - ref['stress']).max() <= 1e-5
    if name == 'multi_cutoff':
        md = MolecularDynamics(m, build_nacl(1000), ensemble='nvt')
        fc.reset_launch_counts()
        md._ef_fn(md.state.pos, md._grid())
        assert {k: v for k, v in fc.launch_counts.items() if v} == {
            'fused_conv_fwd': 5, 'fused_conv_bwd': 5}
