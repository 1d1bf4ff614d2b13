"""The launch plans of the kernels redesigned for Hopper, on the CPU: the
``terms`` pair (``ops/fused_conv_terms.py::terms_fwd_plan`` and
``terms_bwd_plan``, csrc/fused_conv_terms.cu) and the external-weight
backward (``ops/fused_conv_geom.py::extw_tile`` / ``extw_words``, the
``fused_conv_geom_extw`` build of csrc/fused_conv_geom.cu).

``replay_terms_fwd`` runs the ``terms`` forward's arithmetic from its plan's
tables: the hidden layers by the kernel's activation code, w over the live
columns, the SH folded into the CG per row (B), msg = w B x per CG unit into
the compact message, the sum over an output row's rows and si2 by the
swapped path table.

``replay_terms_bwd`` runs the ``terms`` backward's arithmetic the way the
kernel does, from the plan's tables: the message cotangent gm = alpha W^T g
per output row into the compact layout (path by path), the CG folded with it
into Q per live instruction from the term list, then per row T = Q sh,
V = Q x, dw = x . T, dx += w T, dsh += w V, and the MLP's VJP from dw. It is
held against the plain chain's VJP here and in
``tests/test_torch_terms.py::test_kernel_tables_reproduce_plain``. The rest
checks the work mapping: every x channel of every row is one CG item, a warp
of 32-lane items is one row, pass D's parts cover the live columns once, the
shared words fit, and the refusals.
"""

import os

import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
from sevennet_exp_tpu_torch.ops import fused_conv_terms as fct
from sevennet_exp_tpu_torch.ops.tensor_product import (
    FullyConnectedNetSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

torch.set_num_threads(2)
CKPT = 'trained_nacl/checkpoint_best.pth.sevennet'


@pytest.fixture(scope='module')
def ckpt_layers():
    model, _ = SevenNetCheckpoint(CKPT).build_model('cpu')
    return [model.layers[f'{i}_convolution'] for i in range(5)]


def _small(x='4x0e+4x1o+4x2e+4x3o', sh='1x0e+1x1o+1x2e+1x3o', lmax=3):
    """A layer with multiplicities under 32 and 16 SH components."""
    x, shi = Irreps(x), Irreps(sh)
    tp = UVUTensorProductSpec(x, shi, infer_irreps_out(x, shi, lmax, 'full'))
    mlp = FullyConnectedNetSpec((8, 64, 64, tp.weight_numel), 'silu')
    si2 = LinearSpec(tp.irreps_out, x)
    return tp, mlp, si2


def _conv(which, ckpt_layers, agg_d, **kw):
    if which == 'small':
        tp, mlp, si2 = _small()
    else:
        cl = ckpt_layers[int(which[-1])]
        tp, mlp, si2 = cl.tp, cl.weight_nn, cl.si2
    return pfc.FusedConv(tp, mlp, si2, agg_d, **kw)


def _inputs(conv, n_out, agg_d, seed):
    rng = np.random.default_rng(seed)
    rows = n_out * max(agg_d, 1)

    def t(*shape):
        return torch.tensor(rng.normal(size=shape), dtype=torch.float32)

    xg, sh, emb = t(rows, conv.d1), t(rows, conv.f), t(rows, conv.nb)
    ms = torch.tensor(rng.uniform(0.01, 0.1, size=(rows, 1)),
                      dtype=torch.float32)
    ms[torch.tensor(rng.uniform(size=rows) < 0.2)] = 0.0
    mlp_ws = tuple(t(*conv.mlp.param_shapes()[f'w{i}']) * 0.3
                   for i in range(3))
    si2_ws = tuple(t(*conv.si2.param_shapes()[f'w{n}'])
                   for n in range(len(conv.si2.paths)))
    return xg, sh, emb, ms, mlp_ws, si2_ws, t(n_out, conv.d_out)


def replay_terms_bwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws, g):
    """(dxg, dsh, demb) the way the terms backward computes them, from
    ``terms_bwd_plan``'s tables (see the module docstring)."""
    tk = conv._terms
    P, b = tk.plan, tk.bwd_plan(conv.agg_d)
    group, rows = max(conv.agg_d, 1), xg.shape[0]
    n_out = rows // group
    si2t = torch.cat([w.t().reshape(-1) for w in si2_ws])
    gm = xg.new_zeros((n_out, b.n_msg))
    for pth, (cin, mi, mo, dim, out_off, w_off) in enumerate(
            b.gpaths.tolist()):
        wt = si2t[w_off:w_off + mo * mi].reshape(mo, mi)
        for q in range(dim):
            gm[:, cin + q * mi:cin + (q + 1) * mi] = float(
                P.path_alpha[pth]) * (g[:, out_off + q * mo:
                                         out_off + (q + 1) * mo] @ wt)
    mlp_p = {f'w{i}': w for i, w in enumerate(mlp_ws)}
    w = conv.mlp.apply(mlp_p, emb) * ms
    live = torch.tensor(P.live_cols, dtype=torch.long)
    wl = w[:, live]
    dxg = torch.zeros_like(xg)
    dsh = xg.new_zeros((rows, fct.SHS))
    dwl = torch.zeros_like(wl)
    idx, coef = P.idx.tolist(), P.coef.tolist()
    for xoff, mul, l1, l2, col0, cm, _, tb0, tb1 in b.bins.tolist():
        d1, d2 = 2 * l1 + 1, 2 * l2 + 1
        Q = xg.new_zeros((n_out, d1, d2, mul))
        for t in range(tb0, tb1):
            m, n, p = idx[t] & 0xff, (idx[t] >> 8) & 0xff, idx[t] >> 16
            Q[:, m, n] += coef[t] * gm[:, cm + p * mul:cm + (p + 1) * mul]
        Qr = Q.repeat_interleave(group, 0)
        x = xg[:, xoff:xoff + d1 * mul].reshape(rows, d1, mul)
        s = sh[:, l2 * l2:l2 * l2 + d2]
        T = torch.einsum('rmnu,rn->rmu', Qr, s)
        V = torch.einsum('rmnu,rmu->rnu', Qr, x)
        wa = wl[:, col0:col0 + mul]
        dwl[:, col0:col0 + mul] = (x * T).sum(1) * ms
        dxg[:, xoff:xoff + d1 * mul] += (wa[:, None] * T).reshape(rows, -1)
        dsh[:, l2 * l2:l2 * l2 + d2] += (wa[:, None] * V).sum(2)
    dw = torch.zeros_like(w)
    dw[:, live] = dwl
    emb_ = emb.detach().requires_grad_(True)
    (demb,) = torch.autograd.grad(conv.mlp.apply(mlp_p, emb_), emb_, dw)
    dsh = dsh[:, :conv.f] * (ms != 0)
    return dxg, dsh, demb


def _act(x, code):
    """The kernels' activation codes (csrc/fused_conv_terms.cu act_f)."""
    if code == 0:
        return x * torch.sigmoid(x)
    if code == 2:
        return (torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
                - 0.693147180559945309)
    return torch.tanh(x)


def replay_terms_fwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws):
    """Output rows the way the terms forward computes them, from
    ``terms_fwd_plan``'s tables and the launch's scalars (activation code,
    its constant, the layer scales): the hidden layers, w over the live
    columns, the SH folded into the CG per row and fold entry (B), per CG
    unit msg = w B x into the compact message (each element written once),
    the sum over an output row's rows and si2 by the swapped path table."""
    tk = conv._terms
    P, f = tk.plan, tk.fwd_plan(conv.agg_d)
    group, rows = max(conv.agg_d, 1), xg.shape[0]
    n_out = rows // group
    code, cst, s0, s1, s2 = tk.scalars(rows, conv.agg_d)[-5:]
    w0, w1, w2 = mlp_ws
    h = _act(emb @ w0 * s0, code) * cst
    h = _act(h @ w1 * s1, code) * cst
    live = torch.tensor(P.live_cols, dtype=torch.long)
    wl = (h @ w2[:, live]) * s2 * ms
    shp = torch.nn.functional.pad(sh, (0, fct.SHS - sh.shape[1]))
    B = xg.new_zeros((rows, f.nB))
    idx, coef = P.idx.tolist(), P.coef.tolist()
    for b0, d3, d1, sh_off, t0, t1 in f.folds.tolist():
        for t in range(t0, t1):
            m, n = idx[t] & 0xff, (idx[t] >> 8) & 0xff
            B[:, b0 + m * d3] += coef[t] * shp[:, sh_off + n]
    msg = xg.new_zeros((rows, f.n_msg))
    written = np.zeros(f.n_msg, np.int64)
    for a, u0 in P.slices.tolist():
        xoff, mul, l1, l3, b0, col0, cm = f.fins[a].tolist()
        d1, d3 = 2 * l1 + 1, 2 * l3 + 1
        u = torch.arange(u0, min(u0 + 32, mul))
        x = xg[:, xoff:xoff + d1 * mul].reshape(rows, d1, mul)[:, :, u]
        Bb = B[:, b0:b0 + d1 * fct._r4(d3)].reshape(rows, d1, -1)[..., :d3]
        val = wl[:, col0 + u][:, None] * torch.einsum('rmp,rmu->rpu', Bb, x)
        for pc in range(d3):
            msg[:, cm + pc * mul + u] = val[:, pc]
            written[(cm + pc * mul + u).numpy()] += 1
    assert (written == 1).all()
    agg = msg.reshape(n_out, group, f.n_msg).sum(1)
    si2 = torch.cat([w.reshape(-1) for w in si2_ws])
    out = xg.new_zeros((n_out, conv.d_out))
    for pth, (ocol, mo, mi, dim, cin, w_off) in enumerate(f.fpaths.tolist()):
        W = si2[w_off:w_off + mi * mo].reshape(mi, mo)
        for q in range(dim):
            out[:, ocol + q * mo:ocol + (q + 1) * mo] = float(
                P.path_alpha[pth]) * (agg[:, cin + q * mi:cin + (q + 1) * mi]
                                      @ W)
    assert float(out[:, torch.tensor(f.unfed, dtype=torch.long)].abs().sum()
                 ) == 0.0 if f.unfed.size else True
    return out


def _close(a, b):
    np.testing.assert_allclose(
        a.numpy(), b.numpy(), rtol=0,
        atol=1e-5 * max(1.0, float(b.abs().max())))


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
@pytest.mark.parametrize('agg_d', [20, 0], ids=['grid', 'edge_rows'])
def test_bwd_replay_reproduces_plain(ckpt_layers, which, agg_d):
    conv = _conv(which, ckpt_layers, agg_d, cg_mode='terms')
    assert conv.kernel_refusal is None
    xg, sh, emb, ms, mlp_ws, si2_ws, g = _inputs(conv, 6, agg_d, 3)
    if agg_d:
        ms[:agg_d] = 0.0                    # an atom of pads only
    want = conv.plain_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    got = replay_terms_bwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws, g)
    pad = (ms == 0).reshape(-1)
    for a, b in zip(got, want):
        _close(a, b)
        assert float(a[pad].abs().max()) == 0.0


@pytest.mark.parametrize('which', ['small', 'small_ssp', 'layer0', 'layer1',
                                   'layer2', 'layer3', 'layer4'])
@pytest.mark.parametrize('agg_d', [20, 0], ids=['grid', 'edge_rows'])
def test_fwd_replay_reproduces_plain(ckpt_layers, which, agg_d):
    """The terms forward's tables (the sh fold B, the CG units, the swapped
    si2 paths) and activation code against the plain chain."""
    if which == 'small_ssp':
        tp, mlp, si2 = _small()
        conv = pfc.FusedConv(tp, FullyConnectedNetSpec(mlp.hs, 'ssp'), si2,
                             agg_d, cg_mode='terms')
        assert fct._ACT_CODE[conv.mlp.act] == 2
    else:
        conv = _conv(which, ckpt_layers, agg_d, cg_mode='terms')
    assert conv.kernel_refusal is None
    xg, sh, emb, ms, mlp_ws, si2_ws, _ = _inputs(
        conv, 6 if agg_d else 90, agg_d, 5)
    ref = conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    out = replay_terms_fwd(conv, xg, sh, emb, ms, mlp_ws, si2_ws)
    _close(out, ref)
    if not agg_d:
        assert float(out[(ms == 0).reshape(-1)].abs().max()) == 0.0


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
@pytest.mark.parametrize('agg_d', [32, 0], ids=['grid', 'edge_rows'])
def test_fwd_tables_are_consistent(ckpt_layers, which, agg_d):
    """Fold entries: one per (live instruction, p), inside the instruction's
    B block, term runs of its p only; B blocks 16-byte aligned and a row's
    B an odd number of 16 bytes; the compact message is what the paths
    read; tiles, row groups and shared words as the plan's rules say."""
    conv = _conv(which, ckpt_layers, agg_d, cg_mode='terms')
    tk = conv._terms
    P, f = tk.plan, tk.fwd_plan(agg_d)
    assert f.fins.shape[0] == P.ins.shape[0]
    folds = f.folds.tolist()
    k = 0
    for a, (xoff, mul, l1, l3, b0, col0, cm) in enumerate(f.fins.tolist()):
        d1, d3 = 2 * l1 + 1, 2 * l3 + 1
        assert b0 % 4 == 0 and mul == P.ins[a, 1] and xoff == P.ins[a, 0]
        for pc in range(d3):
            bp, fd3, fd1, sh_off, t0, t1 = folds[k]
            k += 1
            assert (bp, fd3, fd1, sh_off) == (b0 + pc, fct._r4(d3), d1,
                                              P.ins[a, 2])
            assert P.ins[a, 6] <= t0 <= t1 <= P.ins[a, 7]
            assert all((int(P.idx[t]) >> 16) & 0xff == pc
                       for t in range(t0, t1))
        assert sum(1 for t in range(P.ins[a, 6], P.ins[a, 7])) == sum(
            fo[5] - fo[4] for fo in folds[k - d3:k])
    assert k == len(folds)
    assert f.nB % 4 == 0 and f.nB % 8 == 4
    assert f.n_msg == int((P.msg_path >= 0).sum())
    assert f.nls == fct._r4(P.live_cols.size)
    assert f.T in (8, 16) and f.s in (1, 2, 4) and f.T % (4 * f.s) == 0
    assert f.T % f.R == 0
    assert 4 * f.words <= (fct.TWO_PER_SM if f.T == 16 else fct.MAX_SMEM)
    if which != 'small':       # the checkpoint: two blocks an SM
        assert 4 * f.words <= fct.TWO_PER_SM
    if which == 'layer1':      # a mid layer's edge-row messages: 8 rows
        assert f.T == (16 if agg_d else 8)


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
def test_fwd_si2_product_covers_every_column_once(ckpt_layers, which):
    """The agg_d = 0 si2 product's work mapping (``si2_rows``): every output
    column a path writes is stored once per row of the tile, its sum over
    every reduction index exactly once (the lanes' parts), and no other
    column is stored (the unfed ones are zeroed apart)."""
    conv = _conv(which, ckpt_layers, 0, cg_mode='terms')
    f = conv._terms.fwd_plan(0)
    writes, reads = fct.si2_row_work(f, conv.d_out)
    fed = np.zeros(writes.shape[1], bool)
    for ocol, mo, mi, dim, *_ in f.fpaths.tolist():
        fed[ocol:ocol + dim * mo] = True
    assert (writes[:, fed] == 1).all() and (writes[:, ~fed] == 0).all()
    for (pth, q, e, c), ks in reads.items():
        assert sorted(ks) == list(range(int(f.fpaths[pth, 2])))
    assert not set(f.unfed.tolist()) & set(np.nonzero(fed)[0].tolist())
    assert f.unfed.size + int(fed.sum()) == conv.d_out


def _items(b, tcg):
    """(x entry, row, channel) of every valid CG item, and the rows of each
    warp whose items are 32-lane ones."""
    got, warps = [], {}
    for k, (start, lanes, groups, _, mul, _, _, _) in enumerate(
            b.xcls.tolist()):
        end = b.xcls[k + 1, 0] if k + 1 < len(b.xcls) else b.n_items
        assert start % 32 == 0 and end - start == -(-tcg * mul // 32) * 32
        assert lanes * groups == mul
        for j in range(start, end):
            e, u = divmod(j - start, mul)
            if e < tcg:
                got.append((k, e, u))
                if lanes == 32:
                    warps.setdefault(j // 32, set()).add(e)
    return got, warps


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
@pytest.mark.parametrize('agg_d', [32, 0])
def test_bwd_cg_items_cover_every_x_channel_once(ckpt_layers, which, agg_d):
    conv = _conv(which, ckpt_layers, agg_d, cg_mode='terms')
    b = conv._terms.bwd_plan(agg_d)
    tcg = b.T if agg_d else 1
    got, warps = _items(b, tcg)
    want = [(k, e, u) for k, (mul, _) in enumerate(conv.tp.irreps_in1)
            for e in range(tcg) for u in range(mul)]
    assert sorted(got) == sorted(want)
    assert all(len(rows) == 1 for rows in warps.values())
    # each live instruction is the user of the x entry it reads, once
    users = b.users.tolist()
    for k, (_, _, _, xoff, mul, l1, nu, u0) in enumerate(b.xcls.tolist()):
        for a in users[u0:u0 + nu]:
            assert b.bins[a, 0] == xoff and b.bins[a, 1] == mul
            assert b.bins[a, 2] == l1
    assert sorted(users) == list(range(len(b.bins)))


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
def test_bwd_tables_are_consistent(ckpt_layers, which):
    """Live columns, Q and the compact message laid out back to back, in
    the plan's instruction order; w2's live columns packed."""
    conv = _conv(which, ckpt_layers, 32, cg_mode='terms')
    tk = conv._terms
    b, P = tk.bwd_plan(32), tk.plan
    col0, q = 0, 0
    for a, (_, mul, l1, l2, c0, cm, qo, tb0, tb1) in enumerate(
            b.bins.tolist()):
        assert (c0, qo) == (col0, q)
        assert (tb0, tb1) == tuple(P.ins[a, 8:10])
        assert 0 <= cm and cm + mul <= b.n_msg
        col0 += mul
        q += mul * (2 * l1 + 1) * (2 * l2 + 1)
    assert (col0, q) == (P.live_cols.size, b.n_q)
    assert b.nls == (col0 + 3) & ~3
    assert b.n_msg == int((P.msg_path >= 0).sum())
    w2 = torch.randn(64, conv.w_numel)
    w2l, w2lt = tk._live_w2(w2)
    assert torch.equal(w2l[:, :col0], w2[:, torch.tensor(P.live_cols,
                                                         dtype=torch.long)])
    assert not w2l[:, col0:].any()
    assert torch.equal(w2lt, w2l.t())


def test_bwd_tiles_and_shared_words(ckpt_layers):
    """The checkpoint's layers: 16-row tiles on the D = 32 grid and 8 on
    the edge list, both at two blocks an SM; the w pass's rows per item;
    pass D's parts cover the live columns once."""
    for i in range(5):
        for dd, T in ((32, 16), (0, 8)):
            conv = _conv(f'layer{i}', ckpt_layers, dd, cg_mode='terms')
            b = conv._terms.bwd_plan(dd)
            assert b.T == T and 4 * b.words <= fct.TWO_PER_SM
            assert b.R in (4, 8, 16) and T % b.R == 0
            nq = b.nls // 4
            per = -(-nq // fct.KS)
            cols = [c for ks in range(fct.KS)
                    for c in range(4 * ks * per, min(4 * (ks + 1) * per,
                                                     b.nls))]
            assert cols == list(range(b.nls))
    assert fct.w_pass_rows(576, 16) == 16 and fct.w_pass_rows(256, 16) == 4
    assert fct.w_pass_rows(576, 8) == 8


def test_terms_refuses_filters_off_l2_squared():
    """A refused layer: the reason, and the kernels' entries raise it (the
    model sends such a layer down the plain chain)."""
    tp, mlp, si2 = _small('4x0e+4x1o', '1x1o+1x0e', 1)
    conv = pfc.FusedConv(tp, mlp, si2, 16, cg_mode='terms')
    assert 'l2^2' in conv.kernel_refusal
    assert fct.terms_unsupported(_small()[0]) is None
    xg, sh, emb, ms, mlp_ws, si2_ws, g = _inputs(conv, 2, 16, 0)
    with pytest.raises(ValueError, match='l2'):
        conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    with pytest.raises(ValueError, match='l2'):
        conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)


@pytest.mark.parametrize('which', ['small', 'layer0', 'layer1', 'layer4'])
def test_extw_tile_and_words(ckpt_layers, which):
    """The external-weight backward: a whole atom of the D = 32 grid at two
    blocks an SM on the checkpoint's layers; shorter tiles when D is
    short; the words grow with the tile by its per-row buffers."""
    conv = _conv(which, ckpt_layers, 32, ext_w=True)
    assert conv.kernel_refusal is None
    d = fcg.extw_dims(conv)
    T = fcg.extw_tile(d)
    assert T == 32 and 4 * fcg.extw_words(d, T) <= fcg.TWO_PER_SM
    per_row = (d['n_active'] + 3 & ~3) + (fcg.NW + 1) * fcg.SHP
    assert fcg.extw_words(d, 16) - fcg.extw_words(d, 8) == 8 * per_row + 8
    assert fcg.extw_tile(dict(d, D=12)) == 16
    assert fcg.extw_tile(dict(d, D=5)) == 8


def test_extw_refuses_filters_off_l2_squared():
    tp, mlp, si2 = _small('4x0e+4x1o', '1x1o+1x0e', 1)
    conv = pfc.FusedConv(tp, mlp, si2, 16, ext_w=True)
    assert 'l2^2' in conv.kernel_refusal


# -- the card tools of the two backwards --------------------------------------

@pytest.mark.parametrize('case', ['terms', 'extw', 'terms_fwd', 'extw_fwd',
                                  'tp_bwd', 'tile_b', 'tile_c'])
def test_pass_stubs_apply_to_the_sources(case):
    """tools/bwd_passes.py inserts every switch of its stub list exactly
    once into the port's sources: the terms pair's, the external-weight
    build of csrc/fused_conv_geom.cu, the bare TP's and bench_tile's."""
    from sevennet_exp_tpu_torch.tools import bwd_passes
    src_dir, target, _, stubs, _ = bwd_passes.plan(case)
    with open(f'{src_dir}/{target}') as fh:
        out = bwd_passes.apply(fh.read(), stubs)
    for p, _, _ in stubs:
        assert f'STUB_{p}' in out
    with pytest.raises(ValueError):
        bwd_passes.apply(out, stubs)


def test_earlier_tp_stubs_fit_the_table_backward():
    """The switches of the bare TP backward's first form (``OLD_TP``, for
    an earlier tree) fit this tree's fused_tp_bwd_table_kernel, which
    keeps that body: a dead anchor fails here."""
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import bwd_passes
    with open(cuda_build.source_path('fused_tp')) as fh:
        text = fh.read()
    body = text[text.index('fused_tp_bwd_table_kernel('):
                text.index('// backward: steps of')]
    for _, old, _ in bwd_passes.OLD_TP:
        assert body.count(old) == 1
    out = bwd_passes.apply(text, bwd_passes.OLD_TP)
    for p, _, _ in bwd_passes.OLD_TP:
        assert f'STUB_{p}' in out


def test_bwd_card_tools_exit_2_without_a_card():
    from sevennet_exp_tpu_torch.tools import bwd_ab, bwd_passes
    assert bwd_ab.main([]) == 2
    assert bwd_ab.main(['csrc', '--terms', '--extw']) == 2
    assert bwd_ab.main(['csrc', '--dot-bf16', '--outer']) == 2
    csrc = os.path.join(os.path.dirname(bwd_ab.__file__), '..', 'csrc')
    for src in bwd_ab.MICRO.values():
        assert os.path.exists(os.path.join(csrc, src))
    assert bwd_passes.main([]) == 2
    assert bwd_passes.main(['csrc', '--terms', '--extw']) == 2
    assert bwd_passes.main(['--terms-fwd', '--extw-fwd']) == 2
    if not torch.cuda.is_available():
        for kind in ('--terms', '--extw', '--terms-fwd', '--extw-fwd'):
            assert bwd_ab.main(['csrc', kind]) == 2
            assert bwd_passes.main([kind]) == 2
            assert bwd_passes.main(['csrc', kind]) == 2
        for kind in ('--dot-bf16', '--outer'):
            assert bwd_ab.main(['csrc', kind]) == 2
