"""The ``bench_pieces`` variants' plain versions against the JAX package.

On the 7net-0 mid layer at full width (``sevennet_0_config(species=['Na',
'Cl'])``, third convolution; d1 = 480, 960 radial weights, 576 outputs),
two atoms of D = 32 rows, numpy inputs and weights:

- ``full`` is ``FusedConv.plain_forward`` and equals the JAX XLA conv chain
  (``IrrepsConvolution._rows_to_nodes`` with the Pallas kernels off:
  MLP -> TP -> sum over the D rows -> si2) within 1e-4 relative;
- each stripped variant equals its stand-in as ``tools/bench_pieces.py``
  defines it (``:100-155``), written here in jnp on the JAX layer's specs
  (its aggregate read as the XLA chain's si2 reads it, ROADMAP C);
- the kernels' own arithmetic for each variant, replayed from
  ``FusedConv.kernel_tables`` the way ``csrc/fused_conv_body.cuh`` runs it
  with the SKIP flags, equals the plain version, so the stand-ins of the
  CUDA kernels and of the plain versions cannot drift apart unseen.

The CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda.py; chip_smoke.py, where ``full`` must equal kernel
1 bit for bit).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu.presets import sevennet_0_config
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.tools import bench_pieces as bp

torch.set_num_threads(2)
D, N_ATOMS = 32, 2
REL = 1e-4


@pytest.fixture(scope='module')
def jax_mid_conv():
    model = build_e3_equivariant_model(sevennet_0_config(species=['Na',
                                                                  'Cl']))
    return [lay for _, lay in model.layers
            if isinstance(lay, JL.IrrepsConvolution)][2]


@pytest.fixture(scope='module')
def conv():
    return bp.mid_layer_conv()


@pytest.fixture(scope='module')
def inputs(conv):
    rng = np.random.default_rng(5)
    rows = N_ATOMS * D
    arrs = [rng.normal(size=(rows, conv.d1)), rng.normal(size=(rows, conv.f)),
            rng.normal(size=(rows, conv.nb)), np.ones((rows, 1))]
    hs = conv.mlp.hs
    mlp = [rng.normal(size=(hs[i], hs[i + 1])) for i in range(3)]
    si2 = [rng.normal(size=(mi, mo)) for (_, _, mi, mo, _) in conv.si2.paths]
    f32 = [np.asarray(a, np.float32) for a in arrs + mlp + si2]
    return f32[:4], f32[4:7], f32[7:]


def _port(conv, variant, inputs):
    (xg, sh, emb, ms), mlp, si2 = inputs
    t = [torch.tensor(a) for a in (xg, sh, emb, ms)]
    return bp.variant_forward(conv, variant, *t,
                              tuple(torch.tensor(w) for w in mlp),
                              tuple(torch.tensor(w) for w in si2)).numpy()


def _jax_stand_in(layer, variant, inputs):
    """The JAX tool's stand-ins on the XLA chain of the JAX layer."""
    (xg, sh, emb, ms), mlp, si2 = (
        [jnp.asarray(a) for a in inputs[0]],
        {f'w{i}': jnp.asarray(w) for i, w in enumerate(inputs[1])},
        {f'w{n}': jnp.asarray(w) for n, w in enumerate(inputs[2])})
    tp, wn = layer.tp, layer.weight_nn.hs[-1]
    if variant == '-mlp':
        w = jnp.broadcast_to(emb[:, 0:1], (xg.shape[0], wn)) * ms
    elif variant == '-w':
        w = jnp.ones((xg.shape[0], wn), jnp.float32)
    else:
        w = layer.weight_nn.apply(mlp, emb) * ms
    if variant == '-cg':
        plan, _ = pallas_conv._tp_plan(tp)
        blocks = [None] * len(tp.irreps_out)
        for p in plan:
            x0 = xg[:, p['x_off']:p['x_off'] + p['mul']]
            wr = w[:, p['w_off']:p['w_off'] + p['mul']]
            blocks[p['k']] = jnp.concatenate([x0 * wr] * p['dim3'], axis=1)
        message = jnp.concatenate(blocks, axis=1)
    else:
        message = tp.apply(xg, sh, w)
    if variant == '-agg':
        return np.asarray(layer.si2.apply(si2, message, skip_bias=True))
    agg = message.reshape((-1, D) + message.shape[1:]).sum(1)
    if variant != '-si2':
        return np.asarray(layer.si2.apply(si2, agg, skip_bias=True))
    groups, d_out = pallas_conv._si2_groups(tp, layer.si2)
    in_slices = layer.si2.irreps_in.slices()
    out = np.zeros((agg.shape[0], d_out), np.float32)
    for g in groups:
        K, mo, d3 = g['K'], g['mo'], g['dim3']
        a = np.asarray(agg[:, in_slices[layer.si2.paths[g['path']][0]]]
                       ).reshape(-1, d3, K)[:, :, :min(K, mo)]
        blk = np.zeros((agg.shape[0], d3, mo), np.float32)
        blk[:, :, :a.shape[2]] = a
        out[:, g['out_off']:g['out_off'] + d3 * mo] = blk.reshape(
            agg.shape[0], -1)
    return out


def _close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * float(np.abs(ref).max()))


def test_full_is_plain_forward_and_the_jax_xla_chain(conv, jax_mid_conv,
                                                     inputs):
    got = _port(conv, 'full', inputs)
    (xg, sh, emb, ms), mlp, si2 = inputs
    ref = conv.plain_forward(*(torch.tensor(a) for a in (xg, sh, emb, ms)),
                             tuple(torch.tensor(w) for w in mlp),
                             tuple(torch.tensor(w) for w in si2)).numpy()
    np.testing.assert_array_equal(got, ref)
    _close(got, _jax_stand_in(jax_mid_conv, 'full', inputs))


@pytest.mark.parametrize('variant', bp.VARIANTS[1:])
def test_stripped_variants_match_jax_stand_ins(conv, jax_mid_conv, inputs,
                                               variant):
    got = _port(conv, variant, inputs)
    _close(got, _jax_stand_in(jax_mid_conv, variant, inputs))
    # a stand-in changes the result: the variant is not the full kernel
    full = _port(conv, 'full', inputs)
    assert got.shape != full.shape or \
        float(np.abs(got - full).max()) > REL * float(np.abs(full).max())


def _replay(conv, variant, xg, sh, emb, ms, mlp_ws, si2_ws):
    """The forward of csrc/fused_conv_body.cuh (fwd_body with SKIP, or the
    M_EDGE body for -agg) from the kernel tables, vectorised over rows."""
    t = conv.kernel_tables(torch.device('cpu'))
    ins = t.ins.reshape(t.n_ins, pfc._I_STRIDE).tolist()
    grp = t.grp.reshape(t.n_grp, pfc._G_STRIDE).tolist()
    nz_idx, coef = t.nz_idx.tolist(), t.nz_coef.tolist()
    rows = xg.shape[0]
    d = 1 if variant == '-agg' else conv.group
    n = rows // d
    if variant == '-mlp':
        w_full = emb[:, :1].expand(-1, conv.w_numel) * ms
    else:
        w_full = conv.mlp.apply({f'w{i}': w for i, w in enumerate(mlp_ws)},
                                emb) * ms
    weff = w_full[:, t.col_w.long()]
    if variant == '-w':                 # live rows add s itself
        weff = (ms != 0).to(xg.dtype).expand_as(weff)
    agg = xg.new_zeros((n, t.agg_dim))
    for I in ins:
        x_off, mul, sh_off, _, d1, d2, d3, a, stride, col0 = I[:10]
        u = torch.arange(mul)
        we = weff[:, col0:col0 + mul]
        for p in range(d3):
            if variant == '-cg':
                s = xg[:, x_off + u]
            else:
                lo, hi = I[10 + p], I[10 + p + 1]
                s = sum(coef[q] * xg[:, x_off + (nz_idx[q] & 0xff) * mul + u]
                        * sh[:, sh_off + ((nz_idx[q] >> 8) & 0xff)][:, None]
                        for q in range(lo, hi))
            agg[:, a + p * stride + u] += (we * s).reshape(n, d, mul).sum(1)
    si2 = torch.cat([w.reshape(-1) for w in si2_ws])
    out = xg.new_zeros((n, conv.d_out))
    for (K, mo, d3, o_off, a_off, w_off), alpha in zip(
            grp, t.grp_alpha.tolist()):
        a3 = agg[:, a_off:a_off + d3 * K].reshape(n, d3, K)
        o = out[:, o_off:o_off + d3 * mo].view(n, d3, mo)
        if variant == '-si2':
            c = min(K, mo)
            o[:, :, :c] = a3[:, :, :c]
        else:
            o[:] = alpha * a3 @ si2[w_off:w_off + K * mo].reshape(K, mo)
    return out


@pytest.mark.parametrize('variant', bp.VARIANTS)
def test_kernel_tables_reproduce_each_variant(conv, inputs, variant):
    (xg, sh, emb, ms), mlp, si2 = inputs
    args = [torch.tensor(a) for a in (xg, sh, emb, ms)] + [
        tuple(torch.tensor(w) for w in mlp),
        tuple(torch.tensor(w) for w in si2)]
    _close(_replay(conv, variant, *args).numpy(),
           bp.plain_variant(conv, variant, *args).numpy())


def test_variant_costs(conv, inputs):
    ms = torch.tensor(inputs[0][3])
    full_f, full_b = bp.variant_cost(conv, ms, 'full')
    assert (full_f, full_b) == (pfc.conv_cost(conv, ms)[0],
                                pfc.conv_bytes(conv, ms)[0])
    for variant in bp.VARIANTS[1:]:
        f, b = bp.variant_cost(conv, ms, variant)
        assert (f > full_f) == (variant == '-agg') and 0 < f
        assert b <= full_b or variant == '-agg'
