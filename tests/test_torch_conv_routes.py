"""Which convolutions run the fused conv and which the plain chain, on the
CPU, and the port against the JAX XLA path where the kernels refuse a
layer:

  - the route is decided from the layer's shapes when the conv is built:
    hidden widths other than 64, a filter not in 1x0+1x1+... order, 16
    x entries (the kernels' table holds 15) and an si2 input entry that
    feeds several output entries (fault C.3: the tables keep one path per
    input entry; every form) are refused with their reason
    (``kernel_refusal``) and run the plain chain; the shifted softplus is
    taken (activation code 2); a layer outside the JAX rule (no si2, si2
    bias) is refused too; no layer of the three committed checkpoints is
    refused;
  - ``use_kernels=False`` (calculator, engine, data dict) sends every
    convolution of ``trained_nacl`` down the plain chain, with the same
    E/F, whole-array and chunk by chunk (fault C.4); geometry fusion
    refuses it;
  - E/F of tiny models the kernels refuse (hidden [32, 32]; 16 x entries)
    and of an ssp model against the JAX calculator
    (``use_pallas=False``): 1e-4 eV (against the float64 sum of JAX's
    atomic energies, as ``test_torch_calculator.py``), 1e-4 eV/A; a
    refused filter layer (``1x1o+1x0e``) and a refused si2 (onto
    ``2x0e+2x1o+2x0e``) against the JAX layer: 1e-5 of its largest
    output.
"""

import copy
import os

import jax
import numpy as np
import pytest
import torch

from samples import tiny_model_config
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.data import graph as jgraph
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu.ops import pallas_tp
from sevennet_exp_tpu.ops import tensor_product as jtp
from sevennet_exp_tpu.irreps import Irreps as JIrreps
from sevennet_exp_tpu.irreps import infer_irreps_out as jinfer
from sevennet_exp_tpu_torch import _keys as KEY
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import (
    SevenNetCheckpoint,
    params_from_numpy,
)
from sevennet_exp_tpu_torch.data.graph import Atoms, build_nacl
from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model import layers as L
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.ops import cuda_build
from sevennet_exp_tpu_torch.ops import fused_conv as fc
from sevennet_exp_tpu_torch.ops import fused_conv_terms as fct
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)
from sevennet_exp_tpu_torch.tools import sass_compare

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NACL = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
X16 = '+'.join(['2x0e', '2x1o'] * 8)    # 16 entries: MAX_XENT
# si2 of the X16 layers: onto simplified irreps, so that the 16-entry cap
# and nothing else refuses them (si2 onto X16 itself is fault C.3)
X16_OUT = '16x0e+16x1o'
# si2 onto irreps that repeat 0e as a separate entry: the TP's 0e entry
# feeds two output entries (fault C.3)
FANOUT = '2x0e+2x1o+2x0e'


def _layer(x='4x0e+4x1o', sh='1x0e+1x1o', hidden=(64, 64), act='silu',
           si2=True, bias=False, out=None):
    x, sh = Irreps(x), Irreps(sh)
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 1, 'full'))
    mlp = FullyConnectedNetSpec((8, *hidden, tp.weight_numel), act)
    lin = (LinearSpec(tp.irreps_out, x if out is None else Irreps(out),
                      biases=bias) if si2 else None)
    return L.IrrepsConvolution(tp, mlp, lin, 10.0)


@pytest.mark.parametrize('kw,why', [
    (dict(hidden=(32, 32)), 'hidden widths must be 64'),
    (dict(hidden=(64, 48)), 'hidden widths must be 64'),
    (dict(sh='1x1o+1x0e'), 'l2^2'),
    (dict(x=X16, out=X16_OUT), 'x entries'),
    (dict(act='relu'), "activation 'relu'"),
    (dict(si2=False), 'no fused conv'),
    (dict(bias=True), 'no fused conv'),
    (dict(out=FANOUT), 'feeds 2 output entries'),
])
@pytest.mark.parametrize('dd', [0, 16])
def test_refused_layers_carry_their_reason(kw, why, dd):
    layer = _layer(**kw)
    got = layer.kernel_refusal(dd)
    assert got is not None and why in got
    if layer._fused_eligible():
        conv = layer._conv(dd)
        assert conv.kernel_refusal == got
        with pytest.raises(ValueError,
                           match='must be 64|l2|x entries|act|feeds'):
            conv._dims(conv.kernel_tables(torch.device('cpu')), 16)


@pytest.mark.parametrize('act', ['silu', 'tanh', 'ssp'])
@pytest.mark.parametrize('dd', [0, 16])
def test_kernel_activations_are_taken(act, dd):
    layer = _layer(act=act)
    assert layer.kernel_refusal(dd) is None
    assert fc._ACT_CODE[act] == {'silu': 0, 'tanh': 1, 'ssp': 2}[act]
    assert layer.kernel_refusal(dd, cg_mode='terms') is None


class _CountFused:
    """Counts the fused conv's calls (its forward dispatch)."""

    def __init__(self, monkeypatch):
        self.n = 0
        orig = fc.FusedConv.forward

        def forward(conv, *args):
            self.n += 1
            return orig(conv, *args)

        monkeypatch.setattr(fc.FusedConv, 'forward', forward)


def _edge_data(layer, rng, n=7, e=40):
    x = torch.tensor(rng.normal(size=(n, layer.tp.irreps_in1.dim)),
                     dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, n, size=(2, e)))
    return {KEY.NODE_FEATURE: x, KEY.EDGE_IDX: idx,
            KEY.EDGE_ATTR: torch.tensor(
                rng.normal(size=(e, layer.tp.irreps_in2.dim)),
                dtype=torch.float32),
            KEY.EDGE_EMBEDDING: torch.tensor(rng.normal(size=(e, 8)),
                                             dtype=torch.float32),
            KEY.EDGE_MASK: torch.tensor(rng.uniform(size=e) > 0.2,
                                        dtype=torch.float32)}


@pytest.mark.parametrize('kw,fused', [
    (dict(), True), (dict(act='ssp'), True), (dict(hidden=(32, 32)), False),
    (dict(sh='1x1o+1x0e'), False), (dict(x=X16, out=X16_OUT), False),
    (dict(out=FANOUT), False)])
def test_layer_routes_by_refusal(monkeypatch, kw, fused):
    """A taken layer calls the fused conv; a refused one never does, and
    gives what the plain chain gives; use_kernels=False never calls it."""
    layer = _layer(**kw)
    rng = np.random.default_rng(1)
    params, _ = layer.init(torch.Generator().manual_seed(1))
    for group, vals in ((layer.weight_nn_p, params['weight_nn']),
                        (layer.si2_p, params['si2'])):
        for k, v in vals.items():
            getattr(group, k).copy_(v)
    data = _edge_data(layer, rng)
    count = _CountFused(monkeypatch)
    out = layer(dict(data))[KEY.NODE_FEATURE]
    assert count.n == int(fused)
    count.n = 0
    plain = layer(dict(data, **{fc.USE_KERNELS_KEY: False}))[KEY.NODE_FEATURE]
    assert count.n == 0
    assert float((out - plain).abs().max()) <= 1e-5 * float(
        plain.abs().max())


def test_refused_filter_layer_equals_jax():
    """The 1x1o+1x0e filter (refused: its SH block is not at l2^2) on the
    plain chain against the JAX layer's XLA path."""
    _refused_layer_equals_jax('1x1o+1x0e', None)


def test_si2_fanout_layer_equals_jax():
    """Fault C.3: si2 onto 2x0e+2x1o+2x0e (the TP's 0e entry feeds two
    output entries), refused, on the plain chain against the JAX layer's
    XLA path."""
    _refused_layer_equals_jax('1x0e+1x1o', FANOUT)


def _refused_layer_equals_jax(filt, out):
    x, sh = '4x0e+4x1o', filt
    layer = _layer(x=x, sh=sh, out=out)
    jx_, jsh = JIrreps(x), JIrreps(sh)
    jtp_spec = jtp.UVUTensorProductSpec(jx_, jsh,
                                        jinfer(jx_, jsh, 1, 'full'))
    jlayer = JL.IrrepsConvolution(
        tp=jtp_spec,
        weight_nn=jtp.FullyConnectedNetSpec(
            (8, 64, 64, jtp_spec.weight_numel), 'silu'),
        si2=jtp.LinearSpec(jtp_spec.irreps_out,
                           jx_ if out is None else JIrreps(out)),
        denominator=10.0)
    jparams, _ = jlayer.init(jax.random.PRNGKey(4))
    state = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams))
    for k, v in state.items():
        group, _, name = k.partition('/')
        if group == 'denominator':
            continue
        getattr(layer.weight_nn_p if group == 'weight_nn' else layer.si2_p,
                name).copy_(v)
    assert layer.kernel_refusal(0) is not None
    data = _edge_data(layer, np.random.default_rng(2))
    out = layer(dict(data))[KEY.NODE_FEATURE].numpy()
    with pallas_tp.disabled():
        jout = jlayer.apply(jparams, {k: jax.numpy.asarray(v.numpy())
                                      for k, v in data.items()})
    want = np.asarray(jout[KEY.NODE_FEATURE])
    np.testing.assert_allclose(out, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def _models(cfg, seed):
    jmodel = jbuild(copy.deepcopy(cfg))
    jparams, _ = jmodel.init(jax.random.PRNGKey(seed))
    model = build_e3_equivariant_model(copy.deepcopy(cfg))
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, model


def _structure():
    at = build_nacl(64, rattle=0.15, seed=3)
    s = 3.4 / 5.63
    return Atoms(at.atomic_numbers, at.pos * s, at.cell * s, at.pbc)


@pytest.mark.parametrize('over,route', [
    ({KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [32, 32]}, 'plain'),
    ({KEY.IRREPS_MANUAL: ['4x0e', X16, '4x0e'],
      KEY.NUM_CONVOLUTION: 2}, 'mixed'),
    ({KEY.ACTIVATION_RADIAL: 'ssp'}, 'kernel'),
])
def test_refused_tiny_models_equal_jax(over, route):
    cfg = tiny_model_config(dict({KEY.NUM_CONVOLUTION: 2}, **over))
    jmodel, jparams, model = _models(cfg, 5)
    routes = [r['route'] for r in model.conv_routes(0)]
    if route == 'mixed':       # layer 1 takes the 16-entry x irreps
        assert routes == ['kernel', 'plain']
        assert 'x entries' in model.conv_routes(0)[1]['refusal']
    else:
        assert set(routes) == {route}
    at = _structure()
    want = JCalc(model=jmodel, params=jparams, use_pallas=False
                 ).calculate_single(jgraph.Atoms(
                     atomic_numbers=at.atomic_numbers, pos=at.pos,
                     cell=at.cell, pbc=at.pbc))
    got = SevenNetCalculator(model, device='cpu').calculate(at)
    assert abs(got['energy']
               - np.asarray(want['energies']).astype(np.float64).sum()
               ) <= 1e-4
    assert np.abs(got['forces'] - np.asarray(want['forces'])).max() <= 1e-4


@pytest.mark.parametrize('dd', [0, 16])
def test_si2_fanout_is_refused_on_every_form(dd):
    """Fault C.3: an si2 input entry that feeds several output entries is
    refused by every kernel form (dense or edge, terms, external weights)
    with its reason, before any table is planned: ``terms_plan`` raises on
    it and the default plan never sees it."""
    layer = _layer(out=FANOUT)
    whys = [layer.kernel_refusal(dd), layer.kernel_refusal(dd, 'terms'),
            layer.kernel_refusal(dd, ext_w=True)]
    assert all(w is not None and 'feeds 2 output entries' in w
               for w in whys), whys
    conv = layer._conv(dd, cg_mode='terms')
    assert conv._terms.refusal(dd) == whys[1] and conv._terms.plan is None
    with pytest.raises(ValueError, match='feeds 2 output entries'):
        fct.terms_plan(layer.tp, layer.si2)
    with pytest.raises(AssertionError, match='feeds two outputs'):
        fc._si2_plan(layer.tp, layer.si2)
    assert conv.d_out == layer.si2.irreps_out.dim == 10
    # one entry an irrep: taken
    assert _layer(out='4x0e+2x1o').kernel_refusal(dd) is None


@pytest.mark.parametrize('name', ['trained_nacl', 'trained_hfo2',
                                  'trained_hfo2_v2'])
def test_committed_checkpoints_keep_the_kernel_route(name):
    """No committed checkpoint has a refused layer: every convolution takes
    the kernels on the grid and the edge list, under both CG modes and on
    the half list."""
    model = SevenNetCheckpoint(os.path.join(
        ROOT, name, 'checkpoint_best.pth.sevennet')).build_model('cpu')[0]
    for dd in (0, 24):
        assert {r['route'] for r in model.conv_routes(dd)} == {'kernel'}
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        assert cl.kernel_refusal(24, 'terms') is None
        assert cl.kernel_refusal(0, 'terms') is None
        assert cl.kernel_refusal(24, ext_w=True) is None


@pytest.fixture(scope='module')
def nacl():
    return SevenNetCheckpoint(NACL).build_model('cpu')[0]


def test_trained_nacl_routes(nacl):
    for dd in (0, 24):
        assert {r['route'] for r in nacl.conv_routes(dd)} == {'kernel'}
        off = nacl.conv_routes(dd, use_kernels=False)
        assert len(off) == 5 and {r['route'] for r in off} == {'plain'}
        assert all('use_kernels' in r['refusal'] for r in off)
    assert L.geom_packed_ok(nacl)


def test_use_kernels_off_calculator_and_engine(monkeypatch, nacl):
    """The switch reaches every convolution through the data dict: no
    fused conv call, the same E/F as the fused conv's plain version."""
    at = build_nacl(64, rattle=0.1, seed=4)
    ref = SevenNetCalculator(nacl, device='cpu').calculate(at)
    count = _CountFused(monkeypatch)
    got = SevenNetCalculator(nacl, device='cpu',
                             use_kernels=False).calculate(at)
    assert count.n == 0
    assert abs(got['energy'] - ref['energy']) <= 1e-4
    assert np.abs(got['forces'] - ref['forces']).max() <= 1e-4
    md_on = MolecularDynamics(nacl, at, device='cpu')
    md_off = MolecularDynamics(nacl, at, device='cpu', use_kernels=False,
                               geom_dense=True, half_mlp=True)
    count.n = 0
    e_off, f_off = md_off._ef_fn(md_off.state.pos, md_off._grid())
    assert count.n == 0
    e_on, f_on = md_on._ef_fn(md_on.state.pos, md_on._grid())
    assert count.n == 5
    assert abs(float(e_on) - float(e_off)) <= 1e-4
    assert float((f_on - f_off).abs().max()) <= 1e-4
    # chunked (fault C.4): the engine takes the switch, its first force
    # call equals the whole-array one and it steps, all on the plain chain
    md_chunk = MolecularDynamics(nacl, at, device='cpu', use_kernels=False,
                                 conv_chunk_atoms=24)
    assert md_chunk.conv_chunk_rows == 24 * md_chunk.deg_cap
    count.n = 0
    cuda_build.reset_launch_counts()
    e_ch, f_ch = md_chunk._ef_fn(md_chunk.state.pos, md_chunk._grid())
    assert abs(float(e_ch) - float(e_off)) <= 1e-4
    assert float((f_ch - f_off).abs().max()) <= 1e-4
    rows = md_chunk.run(2)
    assert count.n == 0 and not any(cuda_build.launch_counts.values())
    assert int(np.sum(rows['steps'])) == 2
    assert np.isfinite(rows['energy']).all()
    assert bool(torch.isfinite(md_chunk.state.pos).all())


def test_refused_model_takes_no_fused_path(monkeypatch):
    """Geometry fusion runs the fused conv only: a model with a refused
    layer is not geometry-fused. Its chunked convolution (fault C.4) runs
    the plain chain chunk by chunk, no fused conv call, and gives the
    whole-array energy and forces."""
    cfg = tiny_model_config({KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS:
                             [32, 32], KEY.NUM_CONVOLUTION: 2})
    _, _, model = _models(cfg, 6)
    assert not L.geom_packed_ok(model)
    at = build_nacl(64, rattle=0.1, seed=5)
    s = 3.4 / 5.63
    at = Atoms(at.atomic_numbers, at.pos * s * 2, at.cell * s * 2, at.pbc)
    md = MolecularDynamics(model, at, device='cpu', conv_chunk_atoms=24)
    assert md.n % 24 and md.conv_chunk_rows == 24 * md.deg_cap
    count = _CountFused(monkeypatch)
    e_c, f_c = md._ef_fn(md.state.pos, md._grid())
    assert count.n == 0
    whole = MolecularDynamics(model, at, device='cpu')
    e_w, f_w = whole._ef_fn(whole.state.pos, whole._grid())
    assert abs(float(e_c) - float(e_w)) <= 1e-4
    assert float((f_c - f_w).abs().max()) <= 1e-4
    assert float(f_w.abs().max()) > 1e-3


def test_sass_pair_names_of_the_ssp_instances():
    """The shifted softplus is a build of its own of csrc/fused_conv_geom.cu
    (the macro FUSED_CONV_SSP, library ``fused_conv_geom_ssp``) whose
    instances carry the other build's names."""
    src = cuda_build.SOURCES
    assert src['fused_conv_geom_ssp'] == src['fused_conv_geom']
    assert src['fused_conv_geom_extw'] == src['fused_conv_geom']
    assert cuda_build.DEFINES == {
        'fused_conv_geom_ssp': ('-DFUSED_CONV_SSP=1',),
        'fused_conv_geom_extw': ('-DFUSED_CONV_EXTW=1',),
        'bench_pieces': ('-DFUSED_CONV_PIECES=1',)}
    paths = {cuda_build.library_path(n) for n in
             ('fused_conv_geom', 'fused_conv_geom_ssp', 'fused_conv_geom_extw')}
    assert len(paths) == 3
    with open(cuda_build.source_path('fused_conv_geom')) as fh:
        assert '#ifndef FUSED_CONV_SSP' in fh.read()
    base = '_ZN12_GLOBAL__N_126fused_conv_geom_{}_kernelI{}EEvPKf'
    cases = {('fwd', 'Li0E'): ('dense', 'fwd'),
             ('fwd', 'Li2E'): ('edge', 'fwd'),
             ('bwd', 'Li9ELi1E'): ('geom', 'bwd9'),
             ('bwd', 'Li16ELi0E'): ('dense', 'bwd16'),
             ('bwd', 'Li4ELb1E'): ('geom', 'bwd4')}      # before MODE
    for (kind, args), want in cases.items():
        name = base.format(kind, args)
        assert (sass_compare.geom_pair(name),
                sass_compare.geom_label(name)) == want, name


@pytest.mark.parametrize('act,build', [('ssp', 'ssp'), ('silu', 'silu'),
                                       ('tanh', 'silu')])
@pytest.mark.parametrize('dd', [0, 16])
def test_ssp_layers_take_the_ssp_build(monkeypatch, act, build, dd):
    """A layer launches the build of csrc/fused_conv_geom.cu for its
    activation, the shifted softplus its own library."""
    monkeypatch.setattr(fc, '_geom_lib', lambda: 'silu')
    monkeypatch.setattr(fc, '_geom_ssp_lib', lambda: 'ssp')
    assert _layer(act=act)._conv(dd)._geom_kernels() == build


def test_external_weight_kernels_take_any_radial_mlp():
    """The external-weight kernels run no MLP: hidden widths and
    activation do not refuse them, the table still does."""
    for kw in (dict(hidden=(32, 32)), dict(act='relu')):
        assert _layer(**kw).kernel_refusal(16, ext_w=True) is None
    assert 'x entries' in _layer(x=X16, out=X16_OUT).kernel_refusal(16)
    assert _layer(x=X16, out=X16_OUT).kernel_refusal(16, ext_w=True) is None


@pytest.mark.parametrize('over', [
    {KEY.IRREPS_MANUAL: ['4x0e', X16, '4x0e']},
    {KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS: [32, 32]}])
def test_half_list_keeps_the_external_weight_route(monkeypatch, over):
    """With the half list each layer asks the external-weight kernels: a
    layer the dense kernels refuse (16 x entries; hidden [32, 32]) keeps
    the external-weight route, with the whole-array path's E/F."""
    cfg = tiny_model_config(dict({KEY.NUM_CONVOLUTION: 2}, **over))
    _, _, model = _models(cfg, 7)
    at = build_nacl(64, rattle=0.1, seed=6)
    calls = []
    orig = fc.FusedConv.extw_forward

    def extw_forward(conv, *args):
        calls.append(conv)
        return orig(conv, *args)

    monkeypatch.setattr(fc.FusedConv, 'extw_forward', extw_forward)
    half = MolecularDynamics(model, at, device='cpu', half_mlp=True)
    whole = MolecularDynamics(model, at, device='cpu')
    e_h, f_h = half._ef_fn(half.state.pos, half._grid())
    assert len(calls) == 2
    e_w, f_w = whole._ef_fn(whole.state.pos, whole._grid())
    assert len(calls) == 2
    assert abs(float(e_h) - float(e_w)) <= 1e-4
    assert float((f_h - f_w).abs().max()) <= 1e-4
