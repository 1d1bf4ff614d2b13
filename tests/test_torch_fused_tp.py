"""The port's bare tensor product (``ops/fused_tp.make_fused_tp``) on the CPU
against the JAX package: ``pallas_tp.make_fused_tp`` in interpret mode and
the XLA ``spec.apply``, on the spec of tests/test_pallas_tp.py and on the
trained checkpoint's five convolution specs, E = 256 rows. Forward atol
1e-5; (dxg, dsh, dw) of a squared-sum objective atol 2e-4 (the JAX test's
tolerances, relative to max|ref| where the checkpoint's widths make the
values large).

``test_kernel_tables_reproduce_plain`` replays the arithmetic of the
forward of csrc/fused_tp.cu from the tables it reads (instruction records,
p-sorted terms) and that of its table-driven backward (and of the CG
stage of csrc/fused_conv_terms.cu) from the n-sorted backward terms of the
same ``pack_plan``; ``test_bwd_tables_reproduce_plain`` replays the step
backward of csrc/fused_tp.cu from its own step records and sh slots
(``bwd_tables``) with the CG terms of csrc/cg_patterns.cuh, so the table
contracts are covered here;
the kernels themselves run only on the card (tests/test_torch_cuda.py,
chip_smoke.py).
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
from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
from sevennet_exp_tpu_torch.ops import fused_tp as ftp
from sevennet_exp_tpu_torch.ops.tensor_product import UVUTensorProductSpec
from sevennet_exp_tpu_torch.tools.cg_patterns import pattern

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
    if which in OTHER_SPECS:    # tests/test_torch_cuda.py's too
        x, sh, lmax = OTHER_SPECS[which]
        x, sh = Irreps(x), Irreps(sh)
        return UVUTensorProductSpec(x, sh,
                                    infer_irreps_out(x, sh, lmax, 'full'))
    return checkpoint_specs[int(which[-1])]


# (x, sh, lmax) of specs beside the checkpoint's: the step backward's
# small multiplicities (4, and 6: no 16-byte runs), sh entries off l^2 and
# out of order; and specs it leaves to the table-driven backward: an l of
# 4, an sh entry of multiplicity 2, two sh entries of one l
OTHER_SPECS = {
    'mul4_l3': ('4x0e+4x1o+4x2e+4x3o', '1x0e+1x1o+1x2e+1x3o', 3),
    'mul6': ('6x0e+6x1o+6x2e', '1x0e+1x1o+1x2e', 2),
    'sh02': ('4x0e+4x1o+4x2e', '1x0e+1x2e', 2),
    'sh10': ('4x0e+4x1o', '1x1o+1x0e', 1),
    'l4': ('4x0e+4x4e', '1x0e+1x4e', 4),
    'sh_mul2': ('4x0e+4x1o', '2x0e+1x1o', 1),
    'dup_l': ('4x0e+4x1o', '1x1o+1x1e', 1),
}
STEP_SPECS = ['mul4_l3', 'mul6', 'sh02', 'sh10']
TABLE_SPECS = ['l4', 'sh_mul2', 'dup_l']


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


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4']
                         + TABLE_SPECS)
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


def replay_bwd_steps(steps, slots, xg, sh, w, g):
    """(dxg, dsh, dw) computed the way the backward of csrc/fused_tp.cu
    does, from its step records and sh slots (``bwd_tables``): per step,
    the lanes' channels u0 .. u0 + STEP_CHANNELS - 1 below mul; the CG
    terms those of ``CgPattern<l1, l2, l3>`` (``tools/cg_patterns.pattern``,
    the header's source) times the step's scale, sh component n of entry l2
    the column in slot l2^2 + n."""
    col = {s: c for c, s in enumerate(slots.tolist())}
    dxg, dsh, dw = (torch.zeros_like(t) for t in (xg, sh, w))
    for x_off, mul, u0, d1, key, w_off, o_off, bits, flags in steps.tolist():
        u = torch.arange(u0, min(u0 + ftp.STEP_CHANNELS, mul))
        if flags & ftp.F_FIRST:
            xv = [xg[:, x_off + m * mul + u] for m in range(d1)]
            dx = [torch.zeros_like(xv[0]) for _ in range(d1)]
        if key != ftp.NO_INS:
            l1, l2, l3 = key >> 4, (key >> 2) & 3, key & 3
            assert 2 * l1 + 1 == d1
            sc = float(np.int32(bits).view(np.float32))
            wv = w[:, w_off + u]
            gm = [g[:, o_off + p * mul + u] * sc for p in range(2 * l3 + 1)]
            t = [torch.zeros_like(wv) for _ in range(d1)]
            v = [torch.zeros_like(wv) for _ in range(2 * l2 + 1)]
            for m, n, p, c in pattern(l1, l2, l3):
                t[m] = t[m] + c * gm[p] * sh[:, col[l2 * l2 + n]][:, None]
                v[n] = v[n] + c * gm[p] * xv[m]
            dw[:, w_off + u] = sum(a * b for a, b in zip(xv, t))
            for m in range(d1):
                dx[m] = dx[m] + wv * t[m]
            for n in range(2 * l2 + 1):
                dsh[:, col[l2 * l2 + n]] += (wv * v[n]).sum(1)
        if flags & ftp.F_LAST:
            for m in range(d1):
                dxg[:, x_off + m * mul + u] = dx[m]
    return dxg, dsh, dw


BWD_SPECS = WHICH + STEP_SPECS


@pytest.mark.parametrize('which', BWD_SPECS)
def test_bwd_tables_reproduce_plain(checkpoint_specs, which):
    spec = _spec(which, checkpoint_specs)
    op = ftp.make_fused_tp(spec)
    assert op.bwd_route == 'steps'
    steps, slots, nsh, lm, run = ftp.bwd_tables(spec)
    assert op.f <= nsh in (1, 4, 9, 16) and 0 <= lm <= 3
    assert sorted(slots.tolist()) == sorted(
        ir.l ** 2 + n for _, ir in spec.irreps_in2 for n in range(ir.dim))
    assert max(slots) < nsh
    assert run == (1 if any(m % 4 for m, _ in spec.irreps_in1) else 4)
    # every channel of every x entry is in one item (first .. last step),
    # and every instruction's channels in exactly one step
    items, ins = [], []
    for x_off, mul, u0, _, key, w_off, _, _, flags in steps.tolist():
        us = range(u0, min(u0 + ftp.STEP_CHANNELS, mul))
        if flags & ftp.F_FIRST:
            items += [(x_off, u) for u in us]
        if key != ftp.NO_INS:
            ins += [(w_off, u) for u in us]
    assert sorted(items) == sorted(
        (sl.start, u) for (mul, _), sl in zip(spec.irreps_in1,
                                               spec.irreps_in1.slices())
        for u in range(mul))
    assert sorted(ins) == sorted((p['w_off'], u) for p in op.plan
                                 for u in range(p['mul']))
    firsts = np.cumsum(steps[:, 8] & ftp.F_FIRST)
    lasts = np.cumsum(steps[:, 8] & ftp.F_LAST) // ftp.F_LAST
    assert (firsts - lasts <= 1).all() and (firsts - lasts >= 0).all()
    assert firsts[-1] == lasts[-1]
    xg, sh, w = (torch.tensor(a) for a in _inputs(spec, 21))
    g = torch.tensor(np.random.default_rng(22).normal(
        size=(E, op.d3)).astype(np.float32))
    got = replay_bwd_steps(steps, slots, xg, sh, w, g)
    for a, b in zip(got, op.plain_backward(g, xg, sh, w)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=1e-5 * float(b.abs().max()))


@pytest.mark.parametrize('which', BWD_SPECS)
def test_cg_nonzeros_factor_as_patterns(checkpoint_specs, which):
    """Each instruction's ``cg_nonzeros()`` is one scale, 1 / sqrt(fan-in),
    times the pattern the backward kernel compiles in (the generator's, and
    so csrc/cg_patterns.cuh's)."""
    spec = _spec(which, checkpoint_specs)
    for (_, nz), (i1, i2, k) in zip(spec.cg_nonzeros(), spec.instructions):
        ls = (spec.irreps_in1[i1].ir.l, spec.irreps_in2[i2].ir.l,
              spec.irreps_out[k].ir.l)
        pat = {t[:3]: t[3] for t in pattern(*ls)}
        p = {'dim1': 2 * ls[0] + 1, 'dim2': 2 * ls[1] + 1,
             'dim3': 2 * ls[2] + 1, 'nz': nz}
        scale = ftp.pattern_scale(p)
        assert {t[:3] for t in nz} == pat.keys()
        np.testing.assert_allclose([t[3] for t in nz],
                                   [scale * pat[t[:3]] for t in nz],
                                   rtol=1e-6)
        # the instruction's path normalisation: 1 / sqrt(fan-in)
        fan = sum(spec.irreps_in2[j].mul for (_, j, kk) in spec.instructions
                  if kk == k)
        assert scale == pytest.approx(fan ** -0.5, rel=1e-6)


def test_bwd_tables_refuse_what_the_kernel_cannot_take():
    """The step kernel refuses an l above 3, an sh entry of multiplicity 2
    and two sh entries of one l, and those specs take the table-driven
    backward; multiplicities that are not multiples of 4 and sh entries
    off l^2 it takes, copying single channels for the first."""
    x = Irreps('4x0e+4x1o')
    for sh in (Irreps('2x0e+1x1o'), Irreps('1x0e+1x1o+1x2e+1x3o+1x4e'),
               Irreps('1x1o+1x1e')):
        spec = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, 4, 'full'))
        with pytest.raises(ValueError):
            ftp.bwd_tables(spec)
        assert ftp.make_fused_tp(spec).bwd_route == 'table'
    for which in TABLE_SPECS:
        with pytest.raises(ValueError):
            ftp.bwd_tables(_spec(which, None))
        assert ftp.make_fused_tp(_spec(which, None)).bwd_route == 'table'
    spec = UVUTensorProductSpec(x, Irreps('1x0e+1x2e'),
                                infer_irreps_out(x, Irreps('1x0e+1x2e'), 4,
                                                 'full'))
    _, slots, nsh, _, run = ftp.bwd_tables(spec)
    assert slots.tolist() == [0, 4, 5, 6, 7, 8] and nsh == 9 and run == 4
    sh = Irreps('1x0e+1x1o')
    spec = UVUTensorProductSpec(Irreps('6x0e+4x1o'), sh,
                                infer_irreps_out(Irreps('6x0e+4x1o'), sh, 1,
                                                 'full'))
    assert ftp.bwd_tables(spec)[4] == 1
    assert ftp.make_fused_tp(spec).bwd_route == 'steps'


# sha256 (first 16 hex digits) of the checkpoint's five layers' tables as
# the parent of the backward's redesign built them: rows 3-4's
# ``terms_plan`` (ins, slices, idx, coef) and the forward's ``pack_plan``
PACK_PLAN_SHA = {'terms_plan': '0a23d5bf2897d796',
                 'pack_plan': 'cf06a9f5c3bcfa2e'}


def test_pack_plan_tables_unchanged_for_rows_3_4_and_the_forward():
    import hashlib
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.ops import fused_conv_terms as fct
    model, _ = SevenNetCheckpoint(CKPT).build_model('cpu')
    got = {k: hashlib.sha256() for k in PACK_PLAN_SHA}
    for i in range(5):
        cl = model.layers[f'{i}_convolution']
        tp = fct.terms_plan(cl.tp, cl.si2)
        for a in (tp.ins, tp.slices, tp.idx, tp.coef):
            got['terms_plan'].update(np.ascontiguousarray(a).tobytes())
        for a in ftp.pack_plan(ftp._plan(cl.tp)[0]):
            got['pack_plan'].update(np.ascontiguousarray(a).tobytes())
    assert {k: h.hexdigest()[:16] for k, h in got.items()} == PACK_PLAN_SHA
