"""The port's bare tensor product (``ops/fused_tp.make_fused_tp``) on the CPU
against the JAX package: ``pallas_tp.make_fused_tp`` in interpret mode and
the XLA ``spec.apply``, on the spec of tests/test_pallas_tp.py and on the
trained checkpoint's five convolution specs, E = 256 rows. Forward atol
1e-5; (dxg, dsh, dw) of a squared-sum objective atol 2e-4 (the JAX test's
tolerances, relative to max|ref| where the checkpoint's widths make the
values large).

``test_kernel_tables_reproduce_plain`` replays the arithmetic of
csrc/fused_tp.cu from the tables the kernels read (instruction records,
p-sorted forward terms, n-sorted backward terms), so the table contract is
covered here; the kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu.irreps import Irreps as JIrreps
from sevennet_exp_tpu.ops import pallas_tp
from sevennet_exp_tpu.ops.tensor_product import (
    UVUTensorProductSpec as JUVU,
)
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
from sevennet_exp_tpu_torch.irreps import Irreps
from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
from sevennet_exp_tpu_torch.ops import fused_tp as ftp
from sevennet_exp_tpu_torch.ops.tensor_product import UVUTensorProductSpec

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'
E = 256


@pytest.fixture(autouse=True)
def interpret_mode():
    pallas_tp.set_interpret(True)
    yield
    pallas_tp.set_interpret(False)


@pytest.fixture(scope='module')
def checkpoint_specs():
    model, _ = SevenNetCheckpoint(CKPT).build_model('cpu')
    return [layer.tp for layer in model.layers.values()
            if isinstance(layer, IrrepsConvolution)]


def _spec(which, checkpoint_specs):
    if which == 'small':
        return UVUTensorProductSpec(Irreps('8x0e+8x1e+8x2e'),
                                    Irreps('1x0e+1x1e+1x2e'),
                                    Irreps('1x0e+1x1e+1x2e'))
    return checkpoint_specs[int(which[-1])]


def _jax_spec(spec):
    return JUVU(JIrreps(repr(spec.irreps_in1)), JIrreps(repr(spec.irreps_in2)),
                JIrreps(repr(spec.irreps_out_filter)))


def _inputs(spec, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(E, d)).astype(np.float32)
            for d in (spec.irreps_in1.dim, spec.irreps_in2.dim,
                      spec.weight_numel)]


def _port_value_grads(fn, ins):
    xs = [torch.tensor(a, requires_grad=True) for a in ins]
    out = fn(*xs)
    grads = torch.autograd.grad((out ** 2).sum(), xs)
    return out.detach().numpy(), [g.numpy() for g in grads]


WHICH = ['small', 'layer0', 'layer1', 'layer2', 'layer3', 'layer4']


@pytest.mark.parametrize('which', WHICH)
@pytest.mark.parametrize('ref', ['pallas_interpret', 'xla'])
def test_port_matches_jax(checkpoint_specs, which, ref):
    import jax
    spec = _spec(which, checkpoint_specs)
    jspec = _jax_spec(spec)
    assert jspec.weight_numel == spec.weight_numel
    ins = _inputs(spec, WHICH.index(which))
    jfn = (pallas_tp.make_fused_tp(jspec, block_e=128)
           if ref == 'pallas_interpret' else jspec.apply)
    jins = [jnp.asarray(a) for a in ins]
    j_out = np.asarray(jfn(*jins))
    j_grads = jax.grad(lambda *a: jnp.sum(jfn(*a) ** 2),
                       argnums=(0, 1, 2))(*jins)
    op = ftp.make_fused_tp(spec)
    assert (op.d3, op.w_numel) == (j_out.shape[1], spec.weight_numel)
    for fn in (op, op.plain_forward):            # autograd wrapper, plain
        p_out, p_grads = _port_value_grads(fn, ins)
        np.testing.assert_allclose(
            p_out, j_out, rtol=0, atol=1e-5 * max(1.0, np.abs(j_out).max()))
        for a, b in zip(p_grads, j_grads):
            b = np.asarray(b)
            np.testing.assert_allclose(
                a, b, rtol=0, atol=2e-4 * max(1.0, np.abs(b).max()))


def test_plan_matches_jax_plan(checkpoint_specs):
    """Offsets, multiplicities and CG terms of the port's ``_plan`` are the
    JAX ``pallas_tp._plan``'s."""
    for spec in checkpoint_specs:
        plan, d3, wn = ftp._plan(spec)
        jplan, jd3, jwn = pallas_tp._plan(_jax_spec(spec))
        assert (d3, wn, len(plan)) == (jd3, jwn, len(jplan))
        for p, q in zip(plan, jplan):
            for key in ('x_off', 'mul', 'sh_off', 'w_off', 'out_off',
                        'dim1', 'dim2', 'dim3'):
                assert p[key] == q[key], key
            assert [t[:3] for t in p['nz']] == [t[:3] for t in q['nz']]
            np.testing.assert_allclose([t[3] for t in p['nz']],
                                       [t[3] for t in q['nz']], atol=1e-7)


def replay_tp_tables(ins, idx, coef, xg, sh, w, g, d_out):
    """(out, dxg, dsh, dw) computed the way csrc/fused_tp.cu (and the CG
    stage of csrc/fused_conv_terms.cu) does, from packed tables: ``ins`` the
    instruction records, ``idx``/``coef`` the term pool. ``w`` has the full
    weight width, ``g`` and ``out`` the message width ``d_out``."""
    out = xg.new_zeros((xg.shape[0], d_out))
    dxg, dsh, dw = (torch.zeros_like(t) for t in (xg, sh, w))
    for x_off, mul, sh_off, w_off, o_off, dim3, tf0, tf1, tb0, tb1 in \
            ins.tolist():
        u = torch.arange(mul)
        wv = w[:, w_off + u]
        t = tf0
        for p in range(dim3):                 # forward: terms sorted by p
            acc = torch.zeros_like(wv)
            while t < tf1 and (idx[t] >> 16) & 0xff == p:
                m, n = idx[t] & 0xff, (idx[t] >> 8) & 0xff
                acc = acc + coef[t] * xg[:, x_off + m * mul + u] \
                    * sh[:, sh_off + n:sh_off + n + 1]
                t += 1
            out[:, o_off + p * mul + u] = acc * wv
        assert t == tf1
        t = tb0
        while t < tb1:                        # backward: groups of one n
            n = (idx[t] >> 8) & 0xff
            sn = torch.zeros_like(wv)
            while t < tb1 and (idx[t] >> 8) & 0xff == n:
                m, p = idx[t] & 0xff, (idx[t] >> 16) & 0xff
                gc = g[:, o_off + p * mul + u] * coef[t]
                x = xg[:, x_off + m * mul + u]
                y = sh[:, sh_off + n:sh_off + n + 1]
                dxg[:, x_off + m * mul + u] += gc * wv * y
                dw[:, w_off + u] += gc * x * y
                sn = sn + gc * x
                t += 1
            dsh[:, sh_off + n] += (sn * wv).sum(1)
    return out, dxg, dsh, dw


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
def test_kernel_tables_reproduce_plain(checkpoint_specs, which):
    spec = _spec(which, checkpoint_specs)
    op = ftp.make_fused_tp(spec)
    ins, slices, idx, coef = ftp.pack_plan(op.plan)
    # every channel of every instruction sits in exactly one warp slice
    covered = sorted((a, u) for a, u0 in slices.tolist()
                     for u in range(u0, min(u0 + 32, op.plan[a]['mul'])))
    assert covered == [(a, u) for a, p in enumerate(op.plan)
                       for u in range(p['mul'])]
    xg, sh, w = (torch.tensor(a) for a in _inputs(spec, 11))
    g = torch.tensor(np.random.default_rng(12).normal(
        size=(E, op.d3)).astype(np.float32))
    out, *grads = replay_tp_tables(ins, idx.tolist(), coef.tolist(), xg, sh,
                                   w, g, op.d3)
    ref = op.plain_forward(xg, sh, w)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=0,
                               atol=1e-5 * float(ref.abs().max()))
    for a, b in zip(grads, op.plain_backward(g, xg, sh, w)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


def test_wrapper_takes_the_plain_version_on_cpu_only(checkpoint_specs):
    op = ftp.make_fused_tp(checkpoint_specs[4])
    assert ftp.make_fused_tp(checkpoint_specs[4]) is op       # cached
    ins = [torch.tensor(a) for a in _inputs(op.spec, 3)]
    ftp.launch_counts['fused_tp_fwd'] = ftp.launch_counts['fused_tp_bwd'] = 0
    out = op(*ins)
    assert torch.equal(out, op.plain_forward(*ins))
    assert ftp.launch_counts['fused_tp_fwd'] == 0          # CPU: no launch
    with pytest.raises(ValueError):
        op.forward(*[t.to('meta') for t in ins])
    rows_f, rows_b = ftp.tp_bytes(op.spec, E)
    width = op.d1 + op.f + op.w_numel
    assert rows_f == 4.0 * E * (width + op.d3)
    assert rows_b == 4.0 * E * (2 * width + op.d3)
