"""The conv kernels of csrc/fused_conv_geom.cu -- the geometry-fused pair
and the dense-grid pair (kernels 1-2), one template there -- held on the
CPU where they cannot run:

  - csrc/cg_patterns.cuh is what tools/cg_patterns.py writes from the port's
    own ``_tp_plan``, byte for byte, for all 34 shapes with l <= 3, and each
    live instruction's table terms are its shape's pattern times one factor
    (the kernels' path normalisation);
  - the launch shape (ops/fused_conv_geom.py) and the work mapping the
    kernels run: every live column of every row exactly once in the column
    passes, every (x entry, row, channel) exactly once in the backward's i1
    classes (entries without live users too: they write zero dxg), at
    checkpoint layers 0, 1 and 4 and on the random plans of the card tests
    (multiplicity 4, lmax 1-3);
  - a numpy replay of the kernels' loop order (row tiles, row-minor MLP,
    column items with their row groups, the CG from the generated patterns,
    the backward's merged passes by i1 class, passes D-F) reproduces
    ``plain_geom_forward`` / ``plain_geom_backward`` within 1e-5 of
    max|plain| on the tiny config's layers, the random plans and checkpoint
    layers 0, 1 and 4;
  - the same for the dense-grid pair: its launch shape on the checkpoint's
    five layers (shared bytes within three forward and two backward blocks
    an SM), its work mapping, and the replay with staged sh / emb rows in
    and dsh / demb rows out against ``plain_forward`` / ``plain_backward``,
    pad rows exactly zero.

The kernels themselves run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import os

import numpy as np
import pytest
import torch

from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.ops import fused_conv_geom as fcg
from sevennet_exp_tpu_torch.ops.normalize import NORMALIZE2MOM_CST
from sevennet_exp_tpu_torch.tools import cg_patterns

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
REL = 1e-5
H = 64


# -- plans ------------------------------------------------------------------

@pytest.fixture(scope='module')
def checkpoint_convs():
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    model, _ = SevenNetCheckpoint(CKPT).build_model('cpu')
    out = {}
    for li in range(5):
        cl = model.layers[f'{li}_convolution']
        mlp_ws, si2_ws = cl._weights()
        out[li] = (cl.tp, cl.weight_nn, cl.si2, cl.geom, mlp_ws, si2_ws)
    return out


def _random_plan(lmax, kind='poly'):
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        FullyConnectedNetSpec, GateSpec, LinearSpec, UVUTensorProductSpec)
    x = Irreps('+'.join(f'4x{l}{"eo"[l % 2]}' for l in range(lmax + 1)))
    sh = Irreps.spherical_harmonics(lmax, -1)
    tp = UVUTensorProductSpec(x, sh, infer_irreps_out(x, sh, lmax, 'full'))
    nb = 10
    mlp = FullyConnectedNetSpec((nb, 64, 64, tp.weight_numel), 'silu')
    gate = GateSpec(x, {1: 'silu', -1: 'tanh'}, {1: 'silu', -1: 'tanh'})
    si2 = LinearSpec(tp.irreps_out, gate.irreps_in)
    geom = pfc.GeomSpec(cutoff=4.0, num_basis=nb, lmax=lmax,
                        cutoff_kind=kind, cutoff_p=6.0,
                        cutoff_on=3.5 if kind == 'xplor' else 0.0)
    return tp, mlp, si2, geom


def _tiny_plans():
    from samples import tiny_model_config
    from sevennet_exp_tpu_torch.model import build as pbuild
    from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
    model = pbuild.build_e3_equivariant_model(tiny_model_config())
    return [(layer.tp, layer.weight_nn, layer.si2, layer.geom)
            for layer in model.layers.values()
            if isinstance(layer, IrrepsConvolution)]


def _random_weights(mlp, si2, seed):
    rng = np.random.default_rng(seed)
    mlp_ws = tuple(torch.tensor(rng.normal(size=s), dtype=torch.float32)
                   for s in mlp.param_shapes().values())
    si2_ws = tuple(torch.tensor(rng.normal(size=si2.param_shapes()[f'w{n}']),
                                dtype=torch.float32)
                   for n in range(len(si2.paths)))
    return mlp_ws, si2_ws


def _plan(which, checkpoint_convs, D, geom=True):
    """(FusedConv, mlp_ws, si2_ws) of 'checkpoint:L', 'random:LMAX[:kind]'
    or 'tiny:L'; geom=False: the dense-grid conv (no GeomSpec)."""
    kind, _, rest = which.partition(':')
    if kind == 'checkpoint':
        tp, mlp, si2, geom, mlp_ws, si2_ws = checkpoint_convs[int(rest)]
    else:
        if kind == 'random':
            lmax, _, env = rest.partition(':')
            tp, mlp, si2, geom = _random_plan(int(lmax), env or 'poly')
        else:
            tp, mlp, si2, geom = _tiny_plans()[int(rest)]
        mlp_ws, si2_ws = _random_weights(mlp, si2, len(which))
    return (pfc.FusedConv(tp, mlp, si2, D, geom=geom if geom else None),
            mlp_ws, si2_ws)


PLANS = ['checkpoint:0', 'checkpoint:1', 'checkpoint:4', 'random:1',
         'random:2', 'random:3']


# -- the generated CG patterns -----------------------------------------------

def test_cg_patterns_header_regenerates_byte_for_byte():
    with open(cg_patterns.HEADER) as fh:
        assert fh.read() == cg_patterns.render()
    assert len(cg_patterns.shapes()) == 34
    assert cg_patterns.main(['--check']) == 0


@pytest.mark.parametrize('which', PLANS + ['random:3:xplor'])
def test_layer_tables_are_patterns_times_one_factor(checkpoint_convs, which):
    """The p-sorted table section of every live instruction lists its
    shape's pattern terms in the same order, each coefficient the
    pattern's times the instruction's factor nzc[first] / c0."""
    conv, _, _ = _plan(which, checkpoint_convs, 16)
    t = conv.kernel_tables(torch.device('cpu'))
    ins = t.ins.numpy().reshape(t.n_ins, -1)
    nz_idx, nz_coef = t.nz_idx.numpy(), t.nz_coef.numpy()
    for rec in ins:
        l1, l2, l3 = ((rec[4:7] - 1) // 2).tolist()
        pat = cg_patterns.pattern(l1, l2, l3)
        q0, q1 = rec[10], rec[10 + rec[6]]
        assert q1 - q0 == len(pat)
        idx = nz_idx[q0:q1]
        assert [(i & 0xff, (i >> 8) & 0xff, i >> 16) for i in idx] == \
            [(m, n, p) for m, n, p, _ in pat]
        sc = nz_coef[q0] / np.float32(pat[0][3])
        np.testing.assert_allclose(nz_coef[q0:q1],
                                   sc * np.array([c for *_, c in pat]),
                                   rtol=1e-6, atol=0)
        # the kernels read an instruction's SH block at l2^2
        assert rec[2] == l2 * l2


# -- launch shape and work mapping --------------------------------------------

@pytest.mark.parametrize('which', PLANS)
@pytest.mark.parametrize('D', [32, 40, 16])
def test_column_items_cover_every_column_once(checkpoint_convs, which, D):
    conv, _, _ = _plan(which, checkpoint_convs, D)
    dims = fcg.layer_dims(conv, D)
    for bwd in (False, True):
        S = fcg.shape(dims, bwd)
        assert S.T % 4 == 0 and S.T <= (fcg.TB if bwd else fcg.TF)
        assert S.T % (4 * S.s) == 0 and S.s in (1, 2, 4)
        assert S.smem <= 232448
        n = dims['n_active']
        for t0 in range(0, D, S.T):
            rows = min(S.T, D - t0)
            seen = np.zeros((n, rows), int)
            for items in fcg.column_items(n, S.T, S.s, rows):
                for c, e0, e1 in items:
                    assert (e1 - e0) % 4 == 0 or e1 == rows
                    seen[c, e0:e1] += 1
            assert (seen == 1).all()
        # pass D's quarters: multiples of 4 that cover the columns
        assert S.cq % 4 == 0 and fcg.QD * S.cq >= n
        assert S.nap % 4 == 0 and S.nap >= n


@pytest.mark.parametrize('which', PLANS)
@pytest.mark.parametrize('D', [32, 40, 16])
def test_class_items_cover_every_x_channel_once(checkpoint_convs, which, D):
    conv, _, _ = _plan(which, checkpoint_convs, D)
    t = conv.kernel_tables(torch.device('cpu'))
    xent = t.xent.numpy().reshape(t.n_xent, -1)
    T = fcg.shape(fcg.layer_dims(conv, D), True).T
    for t0 in range(0, D, T):
        rows = min(T, D - t0)
        seen = {}
        for warp, items in enumerate(fcg.class_items(xent, T, rows)):
            for xe, e, us in items:
                for u in us:
                    seen[(xe, e, u)] = seen.get((xe, e, u), 0) + 1
        want = {(xe, e, u) for xe, (_, mul, _, _, _) in enumerate(xent)
                for e in range(rows) for u in range(mul)}
        assert set(seen) == want and set(seen.values()) == {1}
    # a class of multiplicity 32k keeps each warp on one row
    for C in fcg.classes(xent, T):
        assert C.start % 32 == 0
        if C.lanes == 32:
            assert C.uit * 32 == xent[C.xe][1]


def test_checkpoint_shapes(checkpoint_convs):
    """The numbers PERF.md states for the checkpoint at D = 32."""
    got = {}
    for li in (0, 1, 4):
        conv, _, _ = _plan(f'checkpoint:{li}', checkpoint_convs, 32)
        dims = fcg.layer_dims(conv, 32)
        got[li] = (fcg.shape(dims, False)[:2], fcg.shape(dims, True)[:2])
    assert got == {0: ((16, 1), (16, 1)), 1: ((16, 1), (16, 1)),
                   4: ((16, 1), (16, 1))}
    # two blocks an SM fit every layer
    for li in (0, 1, 4):
        conv, _, _ = _plan(f'checkpoint:{li}', checkpoint_convs, 32)
        dims = fcg.layer_dims(conv, 32)
        assert max(fcg.shape(dims, b).smem for b in (0, 1)) <= \
            fcg.TWO_PER_SM


# -- numpy replay of the kernels' loop order ----------------------------------

def _act(name):
    if name == 'silu':
        return (lambda x: x / (1 + np.exp(-x)),
                lambda x: (1 / (1 + np.exp(-x)))
                * (1 + x * (1 - 1 / (1 + np.exp(-x)))))
    return np.tanh, lambda x: 1 - np.tanh(x) ** 2


class _Replay:
    """The arithmetic of csrc/fused_conv_geom.cu in float64 numpy, in its
    loop order, over all atoms at once; geom=False: the dense-grid pair
    (sh and emb rows in, dsh and demb rows out)."""

    def __init__(self, conv, D, mlp_ws, si2_ws, geom=True):
        self.conv, self.D, self.geom = conv, D, geom
        t = conv.kernel_tables(torch.device('cpu'))
        self.t = t
        self.ins = t.ins.numpy().reshape(t.n_ins, -1)
        self.col_ins, self.col_w = t.col_ins.numpy(), t.col_w.numpy()
        self.nz_coef = t.nz_coef.numpy().astype(np.float64)
        self.grp = t.grp.numpy().reshape(t.n_grp, -1)
        self.alpha = t.grp_alpha.numpy().astype(np.float64)
        self.xent = t.xent.numpy().reshape(t.n_xent, -1)
        self.xins = t.xins.numpy()
        self.w0, self.w1, self.w2 = (w.double().numpy() for w in mlp_ws)
        self.si2 = [w.double().numpy() for w in si2_ws]
        self.si2_flat = np.concatenate([w.reshape(-1) for w in self.si2])
        act = conv.mlp.act
        self.f, self.df = _act(act)
        self.cst = NORMALIZE2MOM_CST[act]
        self.s0, self.s1 = 1 / np.sqrt(conv.nb), 1 / np.sqrt(H)
        self.s2 = 1 / np.sqrt(H)
        self.dims = fcg.layer_dims(conv, D)
        # per instruction: pattern and the factor the kernels take
        self.pat, self.sc = [], []
        for rec in self.ins:
            l1, l2, l3 = ((rec[4:7] - 1) // 2).tolist()
            pat = cg_patterns.pattern(l1, l2, l3)
            self.pat.append(pat)
            self.sc.append(np.float64(np.float32(
                self.nz_coef[rec[10]] / np.float32(pat[0][3]))))

    def geometry(self, vec, coeffs):
        v = torch.tensor(vec, dtype=torch.float64)
        emb, sh = pfc.geom_rows(v, torch.tensor(coeffs, dtype=torch.float64),
                                self.conv.geom)
        return emb.numpy(), sh.numpy()

    def hidden(self, emb):
        """(atoms, T, nb) -> h0, h1, da0, da1 as the row-minor passes."""
        p0 = (emb @ self.w0) * self.s0
        h0 = self.f(p0) * self.cst
        p1 = (h0 @ self.w1) * self.s1
        return (h0, self.f(p1) * self.cst, self.df(p0) * self.cst,
                self.df(p1) * self.cst)

    def tiles(self, T):
        for t0 in range(0, self.D, T):
            yield t0, min(T, self.D - t0)

    def forward(self, xg, vec, ms, coeffs):
        return self.forward_rows(xg, *self.geometry(vec, coeffs), ms)

    def forward_rows(self, xg, emb, sh, ms):
        """The forward on the tile's emb and sh rows (the geometry's, or
        the dense pair's staged inputs)."""
        n = xg.shape[0] // self.D
        X = xg.astype(np.float64).reshape(n, self.D, -1)
        emb = emb.astype(np.float64).reshape(n, self.D, -1)
        sh = sh.astype(np.float64).reshape(n, self.D, -1)
        M = ms.astype(np.float64).reshape(n, self.D)
        S = fcg.shape(self.dims, False, self.geom)
        n_act, agg_dim = self.t.n_active, self.t.agg_dim
        aggp = np.zeros((S.s, n, agg_dim))
        R = S.T // S.s
        for t0, rows in self.tiles(S.T):
            sl = slice(t0, t0 + rows)
            _, h1, _, _ = self.hidden(emb[:, sl])
            for items in fcg.column_items(n_act, S.T, S.s, rows):
                for c, e0, e1 in items:
                    ii = self.col_ins[c]
                    rec = self.ins[ii]
                    u = c - rec[9]
                    w = (h1[:, e0:e1] @ self.w2[:, self.col_w[c]]) \
                        * (self.sc[ii] * self.s2) * M[:, sl][:, e0:e1]
                    xr = X[:, sl][:, e0:e1]
                    sr = sh[:, sl][:, e0:e1]
                    l2 = (rec[5] - 1) // 2
                    s = np.zeros((n, e1 - e0, rec[6]))
                    for m, nn, p, cf in self.pat[ii]:
                        s[..., p] += (np.float64(cf)
                                      * xr[..., rec[0] + m * rec[1] + u]
                                      * sr[..., l2 * l2 + nn])
                    acc = np.einsum('ae,aep->ap', w, s)
                    g = e0 // R
                    for p in range(rec[6]):
                        aggp[g, :, rec[7] + p * rec[8] + u] += acc[:, p]
        agg = aggp.sum(0)
        out = np.zeros((n, self.conv.d_out))
        for gi, G in enumerate(self.grp):
            K, mo, d3, o_off, a_off, w_off = G
            W = self.si2_flat[w_off:w_off + K * mo].reshape(K, mo)
            a = agg[:, a_off:a_off + d3 * K].reshape(n, d3, K)
            out[:, o_off:o_off + d3 * mo] = (
                np.einsum('apk,ko->apo', a, W) * self.alpha[gi]
            ).reshape(n, -1)
        return out

    def backward(self, g, xg, vec, ms, coeffs):
        dxg, dsh, demb = self.backward_rows(
            g, xg, *self.geometry(vec, coeffs), ms)
        # geometry VJP of (demb, dsh); pad rows give zeros
        v = torch.tensor(vec, dtype=torch.float64, requires_grad=True)
        e_, s_ = pfc.geom_rows(v, torch.tensor(coeffs, dtype=torch.float64),
                               self.conv.geom)
        (dvec,) = torch.autograd.grad(
            (e_, s_), v, (torch.tensor(demb), torch.tensor(dsh)))
        dvec = dvec.numpy() * (ms != 0)
        return dxg, dvec

    def backward_rows(self, g, xg, emb, sh, ms):
        """(dxg, dsh, demb) rows of the backward on the tile's emb and sh
        rows; dsh and demb zero on pad rows, as the dense pair stores
        them."""
        n = xg.shape[0] // self.D
        X = xg.astype(np.float64).reshape(n, self.D, -1)
        emb = emb.astype(np.float64).reshape(n, self.D, -1)
        sh = sh.astype(np.float64).reshape(n, self.D, -1)
        M = ms.astype(np.float64).reshape(n, self.D)
        G64 = g.astype(np.float64)
        # gm = si2^T g, once per atom
        gm = np.zeros((n, self.t.agg_dim))
        for gi, Gr in enumerate(self.grp):
            K, mo, d3, o_off, a_off, w_off = Gr
            W = self.si2_flat[w_off:w_off + K * mo].reshape(K, mo)
            gp = G64[:, o_off:o_off + d3 * mo].reshape(n, d3, mo)
            gm[:, a_off:a_off + d3 * K] = (
                np.einsum('apo,ko->apk', gp, W) * self.alpha[gi]
            ).reshape(n, -1)
        S = fcg.shape(self.dims, True, self.geom)
        dxg, dsh, demb = self.backward_tiles(X, emb, sh, M, gm, S)
        live = (M != 0)[..., None]
        return (dxg.reshape(xg.shape), (dsh * live).reshape(-1, sh.shape[-1]),
                (demb * live).reshape(-1, emb.shape[-1]))

    def backward_tiles(self, X, emb, sh, M, gm, S):
        """The tiles' passes of the backward on (n, D, .) rows: the w pass,
        the i1 classes and passes D-F. gm: (n, agg) one message cotangent
        for all D rows (the dense pairs), or (n, D, agg) one per row (the
        edge pair)."""
        n, D = M.shape
        n_act = self.t.n_active
        dxg = np.zeros_like(X)
        demb = np.zeros_like(emb)
        dsh = np.zeros_like(sh)
        for t0 in range(0, D, S.T):
            rows = min(S.T, D - t0)
            sl = slice(t0, t0 + rows)
            h0, h1, da0, da1 = self.hidden(emb[:, sl])
            Mt = M[:, sl]
            # per row: (n, rows, agg); for all rows: (n, 1, agg)
            gmt = gm[:, sl] if gm.ndim == 3 else gm[:, None]
            # column items: w = MLP * s2 * ms into the w / dw rows
            wdw = np.zeros((n, rows, n_act))
            for items in fcg.column_items(n_act, S.T, S.s, rows):
                for c, e0, e1 in items:
                    wdw[:, e0:e1, c] = (h1[:, e0:e1]
                                        @ self.w2[:, self.col_w[c]]) \
                        * self.s2 * Mt[:, e0:e1]
            # i1 classes: every live instruction of the entry, merged
            dw = np.zeros_like(wdw)
            xr, sr = X[:, sl], sh[:, sl]
            for xe, (xoff, mul, dim, n_ins, ins0) in enumerate(self.xent):
                us = np.arange(mul)
                xv = np.stack([xr[..., xoff + m * mul + us]
                               for m in range(dim)], -1)   # (a, e, u, m)
                dx = np.zeros_like(xv)
                for ii in self.xins[ins0:ins0 + n_ins]:
                    rec = self.ins[ii]
                    l2 = (rec[5] - 1) // 2
                    cols = rec[9] + us
                    w = wdw[..., cols]
                    gmv = np.stack([gmt[..., rec[7] + p * rec[8] + us]
                                    for p in range(rec[6])], -1) * self.sc[ii]
                    tm = np.zeros(xv.shape)
                    vn = np.zeros(xv.shape[:3] + (rec[5],))
                    for m, nn, p, cf in self.pat[ii]:
                        gg = np.float64(cf) * gmv[..., p]
                        tm[..., m] += gg * sr[..., l2 * l2 + nn, None]
                        vn[..., nn] += gg * xv[..., m]
                    dw[..., cols] = (xv * tm).sum(-1) * Mt[..., None]
                    dx += w[..., None] * tm
                    dsh[:, sl, l2 * l2:l2 * l2 + rec[5]] += (
                        w[..., None] * vn).sum(2)
                for m in range(dim):
                    dxg[:, sl, xoff + m * mul + us] = dx[..., m] * (
                        Mt[..., None] != 0)
            # passes D, E, F
            dh1 = dw @ self.w2[:, self.col_w].T
            dp1 = dh1 * self.s2 * da1
            dp0 = (dp1 @ self.w1.T) * self.s1 * da0
            demb[:, sl] = (dp0 @ self.w0.T) * self.s0
        return dxg, dsh, demb


    # -- the edge pair: tiles of rows of the edge list, one message
    # (cotangent) per row --

    @staticmethod
    def edge_rows(T, *arrays):
        """(n_tiles, T, .) float64 views of per-row arrays, the last tile
        padded with rows of zeros (ms = 0: pads)."""
        E = arrays[0].shape[0]
        nt = -(-E // T)
        out = []
        for a in arrays:
            a = a.astype(np.float64).reshape(E, -1)
            z = np.zeros((nt * T - E, a.shape[1]))
            out.append(np.concatenate([a, z]).reshape(nt, T, -1))
        return out

    @staticmethod
    def group_product(A, B, T, d3, kred, n, red_words):
        """sum_k A[..., k] B[k] the way row_product sums it: part q of a
        block taking its k, part 0 adding the others in order."""
        plan = fcg.product_plan(T, d3, kred, n, red_words)
        acc = 0.0
        for q in range(plan.ks):
            ks = fcg.product_ks(plan, q, kred)
            assert len(set(ks)) == len(ks)
            acc = acc + A[..., ks] @ B[ks]
        return acc

    def forward_edge(self, xg, emb, sh, ms):
        """The edge forward (agg_d = 0): per tile the hidden layers, then
        per si2 group the w pass over its columns, the CG of its (column,
        part of the rows) items into the group's message tile (one message
        a row) and the product of the tile with W."""
        E = xg.shape[0]
        F = fcg.edge_fwd_plan(self.dims, self.t)
        T = F.T
        assert T >= 4
        X, emb, sh, M = self.edge_rows(T, xg, emb, sh, ms)
        M = M[..., 0]
        nt = M.shape[0]
        _, h1, _, _ = self.hidden(emb)
        out = np.zeros((nt, T, self.conv.d_out))
        for gi, G in enumerate(F.groups):
            # the w pass over the group's columns: its own row groups
            s = fcg.w_row_groups(G.nc, T)
            w = np.zeros((nt, T, F.nc4))
            for items in fcg.column_items(G.nc, T, s, T):
                for lc, e0, e1 in items:
                    w[:, e0:e1, lc] = (
                        h1[:, e0:e1] @ self.w2[:, self.col_w[G.c0 + lc]]) \
                        * self.s2 * M[:, e0:e1]
            # the CG: every slot of the group's slice is some column's
            msg = np.full((nt, T, G.d3 * G.K), np.nan)
            sp = fcg.cg_parts(G.nc)
            R = T // sp
            for j in range(G.nc * sp):
                lc, q = j % G.nc, j // G.nc
                c = G.c0 + lc
                ii = self.col_ins[c]
                rec = self.ins[ii]
                assert G.a0 <= rec[7] < G.a0 + G.d3 * G.K
                u = c - rec[9]
                l2 = (rec[5] - 1) // 2
                rs = slice(q * R, q * R + R)
                sv = np.zeros((nt, R, rec[6]))
                for m, nn, p, cf in self.pat[ii]:
                    sv[..., p] += (np.float64(cf)
                                   * X[:, rs, rec[0] + m * rec[1] + u]
                                   * sh[:, rs, l2 * l2 + nn])
                for p in range(rec[6]):
                    msg[:, rs, rec[7] - G.a0 + p * rec[8] + u] = \
                        w[:, rs, lc] * sv[..., p] * self.sc[ii]
            assert not np.isnan(msg).any()
            W = self.si2_flat[G.w_off:G.w_off + G.K * G.mo].reshape(
                G.K, G.mo)
            A = msg.reshape(nt, T, G.d3, G.K)
            out[..., G.o_off:G.o_off + G.d3 * G.mo] = (self.group_product(
                A, W, T, G.d3, G.K, G.mo, F.red_words)
                * self.alpha[gi]).reshape(nt, T, -1)
        return out.reshape(nt * T, -1)[:E]

    def backward_edge(self, g, xg, emb, sh, ms):
        """(dxg, dsh, demb) of the edge backward: per tile gm = alpha g
        W^T per row by the group products, then the dense pair's passes
        with each row's own gm; pad rows exactly zero."""
        E = xg.shape[0]
        T = fcg.TE
        G64, X, emb, sh, M = self.edge_rows(T, g, xg, emb, sh, ms)
        M = M[..., 0]
        nt = M.shape[0]
        gm = np.zeros((nt, T, self.t.agg_dim))
        for gi, Gr in enumerate(self.grp):
            K, mo, d3, o_off, a_off, w_off = Gr
            WT = self.si2_flat[w_off:w_off + K * mo].reshape(K, mo).T
            A = G64[..., o_off:o_off + d3 * mo].reshape(nt, T, d3, mo)
            gm[..., a_off:a_off + d3 * K] = (self.group_product(
                A, WT, T, d3, mo, K, fcg.edge_red_words(self.dims))
                * self.alpha[gi]).reshape(nt, T, -1)
        S = fcg.shape(self.dims, True, edge=True)
        dxg, dsh, demb = self.backward_tiles(X, emb, sh, M, gm, S)
        live = (M != 0)[..., None]
        return tuple((a * live).reshape(nt * T, -1)[:E]
                     for a in (dxg, dsh, demb))


def _geom_inputs(conv, n, D, seed):
    rng = np.random.default_rng(seed)
    rows = n * D
    rc = conv.geom.cutoff
    u = rng.normal(size=(rows, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    vec = (u * rng.uniform(0.3 * rc, 1.02 * rc, size=(rows, 1))).astype(
        np.float32)
    ms = rng.uniform(0.01, 0.05, size=(rows, 1)).astype(np.float32)
    pad = rng.uniform(size=rows) < 0.2
    ms[pad] = 0.0
    vec[pad] = [1.0, 0.0, 0.0]
    coeffs = (np.arange(1, conv.nb + 1) * np.pi / rc).astype(np.float32)
    xg = rng.normal(size=(rows, conv.d1)).astype(np.float32)
    g = rng.normal(size=(n, conv.d_out)).astype(np.float32)
    return xg, vec, ms, coeffs, g


@pytest.mark.parametrize('which,D', [
    ('tiny:0', 16), ('tiny:1', 40), ('random:1', 16), ('random:2', 20),
    ('random:3', 16), ('random:3:xplor', 40), ('checkpoint:0', 32),
    ('checkpoint:1', 40), ('checkpoint:4', 32)])
def test_replay_reproduces_plain(checkpoint_convs, which, D):
    conv, mlp_ws, si2_ws = _plan(which, checkpoint_convs, D)
    xg, vec, ms, coeffs, g = _geom_inputs(conv, 3, D, len(which) + D)
    rep = _Replay(conv, D, mlp_ws, si2_ws)
    T = (torch.tensor(a) for a in (xg, vec, ms, coeffs))
    xg_t, vec_t, ms_t, co_t = T
    y_p = conv.plain_geom_forward(xg_t, vec_t, ms_t, co_t, mlp_ws,
                                  si2_ws).numpy()
    y_r = rep.forward(xg, vec, ms, coeffs)
    np.testing.assert_allclose(y_r, y_p, rtol=0,
                               atol=REL * np.abs(y_p).max())
    d_p = conv.plain_geom_backward(torch.tensor(g), xg_t, vec_t, ms_t, co_t,
                                   mlp_ws, si2_ws)
    d_r = rep.backward(g, xg, vec, ms, coeffs)
    for a, b in zip(d_r, d_p):
        b = b.numpy()
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())
    pad = ms[:, 0] == 0
    assert np.abs(d_r[0][pad]).max() == 0 and np.abs(d_r[1][pad]).max() == 0


# -- the dense-grid pair (kernels 1-2: no geometry) ----------------------------

@pytest.mark.parametrize('layer', range(5))
@pytest.mark.parametrize('D', [32, 40, 16])
def test_dense_launch_shape_fits_three_forward_two_backward_blocks(
        checkpoint_convs, layer, D):
    """The checkpoint's five layers: the dense pair's tile and row groups
    are the geometry-fused pair's, its shared bytes those less the edge
    vectors' T * 3 words, within three forward and two backward blocks an
    SM."""
    conv, _, _ = _plan(f'checkpoint:{layer}', checkpoint_convs, D, geom=False)
    dims = fcg.layer_dims(conv, D)
    for bwd, limit in ((False, fcg.THREE_PER_SM), (True, fcg.TWO_PER_SM)):
        S, Sg = fcg.shape(dims, bwd, geom=False), fcg.shape(dims, bwd)
        assert S[:4] == Sg[:4]
        assert S.T == min(16, -(-D // 4) * 4) and S.s == 1
        assert S.smem == Sg.smem - 4 * (-(-S.T * 3 // 4) * 4)
        assert S.smem <= limit


@pytest.mark.parametrize('which', PLANS)
@pytest.mark.parametrize('D', [32, 40, 16])
def test_dense_items_cover_every_column_and_x_channel_once(
        checkpoint_convs, which, D):
    conv, _, _ = _plan(which, checkpoint_convs, D, geom=False)
    dims = fcg.layer_dims(conv, D)
    t = conv.kernel_tables(torch.device('cpu'))
    xent = t.xent.numpy().reshape(t.n_xent, -1)
    n = dims['n_active']
    for bwd in (False, True):
        S = fcg.shape(dims, bwd, geom=False)
        for t0 in range(0, D, S.T):
            rows = min(S.T, D - t0)
            seen = np.zeros((n, rows), int)
            for items in fcg.column_items(n, S.T, S.s, rows):
                for c, e0, e1 in items:
                    seen[c, e0:e1] += 1
            assert (seen == 1).all()
            if not bwd:
                continue
            got = {}
            for items in fcg.class_items(xent, S.T, rows):
                for xe, e, us in items:
                    for u in us:
                        got[(xe, e, u)] = got.get((xe, e, u), 0) + 1
            want = {(xe, e, u) for xe, (_, mul, _, _, _) in enumerate(xent)
                    for e in range(rows) for u in range(mul)}
            assert set(got) == want and set(got.values()) == {1}


def _dense_inputs(conv, n, D, seed):
    """xg, sh, emb, ms with a fifth of the rows pads (ms = 0, their sh and
    emb rows random all the same) and a node cotangent."""
    rng = np.random.default_rng(seed)
    rows = n * D
    ms = rng.uniform(0.01, 0.05, size=(rows, 1)).astype(np.float32)
    ms[rng.uniform(size=rows) < 0.2] = 0.0
    return (rng.normal(size=(rows, conv.d1)).astype(np.float32),
            rng.normal(size=(rows, conv.f)).astype(np.float32),
            rng.normal(size=(rows, conv.nb)).astype(np.float32), ms,
            rng.normal(size=(n, conv.d_out)).astype(np.float32))


@pytest.mark.parametrize('which,D', [
    ('tiny:0', 16), ('tiny:1', 40), ('random:3', 16), ('checkpoint:0', 32),
    ('checkpoint:1', 40), ('checkpoint:4', 32)])
def test_dense_replay_reproduces_plain(checkpoint_convs, which, D):
    """Staged sh / emb rows in, dsh / demb rows out: the replay of the dense
    pair against plain_forward / plain_backward at 1e-5 of max|plain|; the
    pad rows' dxg, dsh and demb exactly zero."""
    conv, mlp_ws, si2_ws = _plan(which, checkpoint_convs, D, geom=False)
    assert pfc.dense_unsupported(conv.tp) is None
    xg, sh, emb, ms, g = _dense_inputs(conv, 3, D, len(which) + D)
    rep = _Replay(conv, D, mlp_ws, si2_ws, geom=False)
    ins = [torch.tensor(a) for a in (xg, sh, emb, ms)]
    y_p = conv.plain_forward(*ins, mlp_ws, si2_ws).numpy()
    y_r = rep.forward_rows(xg, emb, sh, ms)
    np.testing.assert_allclose(y_r, y_p, rtol=0,
                               atol=REL * np.abs(y_p).max())
    d_p = conv.plain_backward(torch.tensor(g), *ins, mlp_ws, si2_ws)
    d_r = rep.backward_rows(g, xg, emb, sh, ms)
    pad = ms[:, 0] == 0
    assert pad.any()
    for a, b in zip(d_r, d_p):
        b = b.numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=REL * np.abs(b).max())
        assert np.abs(a[pad]).max() == 0


def test_dense_kernels_refuse_plans_they_cannot_hold():
    """Kernels 1-2 keep the SH operands in registers at l2^2 (at most 16)
    and a table of fewer than 16 x entries: other plans raise before any
    launch, the plain version still takes them."""
    from sevennet_exp_tpu_torch.irreps import Irreps, infer_irreps_out
    from sevennet_exp_tpu_torch.ops.tensor_product import (
        UVUTensorProductSpec)
    x = Irreps('4x0e+4x1o')
    for sh, why in (('1x1o+1x0e', 'l2^2'),
                    ('1x0e+1x1o+1x2e+1x3o+1x4e', 'SH components')):
        tp = UVUTensorProductSpec(x, Irreps(sh),
                                  infer_irreps_out(x, Irreps(sh), 1, 'full'))
        assert why in pfc.dense_unsupported(tp)
    many = Irreps('+'.join(['1x0e'] * 16))
    tp = UVUTensorProductSpec(many, Irreps('1x0e'),
                              infer_irreps_out(many, Irreps('1x0e'), 0,
                                               'full'))
    assert 'x entries' in pfc.dense_unsupported(tp)
    assert pfc.dense_unsupported(_random_plan(3)[0]) is None


# -- the card tools of the pair ------------------------------------------------

def test_pass_stubs_apply_to_the_source():
    """tools/geom_passes.py inserts one switch per pass of NEW_STUBS into
    csrc/fused_conv_geom.cu (every anchor found exactly once), the dense
    pair's passes included."""
    from sevennet_exp_tpu_torch.ops import cuda_build
    from sevennet_exp_tpu_torch.tools import geom_passes
    with open(cuda_build.source_path('fused_conv_geom')) as fh:
        text = fh.read()
    out = geom_passes.apply(text, geom_passes.NEW_STUBS)
    assert out.count('#ifdef STUB_') >= len(geom_passes.NEW_PASSES)
    for p in (geom_passes.NEW_PASSES + geom_passes.DENSE_PASSES
              + geom_passes.EDGE_PASSES):
        assert f'STUB_{p}' in out
    # the edge pair's products get a stand-in of their own
    assert out.count('#ifdef STUB_SI2') == 3
    with pytest.raises(ValueError):
        geom_passes.apply(out, geom_passes.NEW_STUBS)


def test_card_tools_exit_2_without_a_card():
    """Both tools, for each pair (``--dense``: kernels 1-2; ``--edge``:
    their edge-row form)."""
    from sevennet_exp_tpu_torch.tools import geom_ab, geom_passes
    assert geom_ab.main([]) == 2
    assert geom_ab.main(['--dense']) == 2
    assert geom_ab.main(['--edge']) == 2
    assert geom_ab.main(['other.cu', '--dense', '--edge']) == 2
    assert geom_passes.main(['other.cu', '--edge']) == 2
    if not torch.cuda.is_available():
        assert geom_ab.main(['other.cu']) == 2
        assert geom_ab.main(['other.cu', '--dense']) == 2
        assert geom_ab.main(['other.cu', '--edge']) == 2
        assert geom_passes.main([]) == 2
        assert geom_passes.main(['--dense']) == 2
        assert geom_passes.main(['--edge']) == 2


def test_kernel_sin_cos_emulated_in_float32():
    """csrc/fused_conv_geom.cu's sin_cos (three-part reduction by pi/2,
    minimax polynomials), step by step in float32 with fused multiply-adds,
    against the double-precision values on the Bessel arguments' range."""
    import re
    from sevennet_exp_tpu_torch.ops import cuda_build
    with open(cuda_build.source_path('fused_conv_geom')) as fh:
        src = fh.read()
    body = src[src.index('void sin_cos('):]
    body = body[:body.index('\n}\n')]
    c = [np.float32(float(v)) for v in re.findall(
        r'([-+]?\d\.\d+(?:e[-+]\d+)?)f', body)]
    assert len(c) == 12
    inv_half_pi, p1, p2, p3 = c[0:4]
    ps, pc = c[4:8], c[8:12]
    f32 = np.float32

    def fma(a, b, d):
        return f32(np.float64(a) * np.float64(b) + np.float64(d))

    x = np.linspace(-30.0, 30.0, 6001).astype(np.float32)
    j = np.rint(x * inv_half_pi).astype(np.float32)
    r = fma(j, p1, x)
    r = fma(j, p2, r)
    r = fma(j, p3, r)
    r2 = (r * r).astype(np.float32)
    s = ps[0]
    for k in ps[1:]:
        s = fma(s, r2, k)
    sr = fma((s * r2).astype(np.float32), r, r)
    q = pc[0]
    for k in pc[1:]:
        q = fma(q, r2, k)
    cr = fma(q, r2, f32(1.0))
    quad = j.astype(np.int64) & 3
    sv = np.where(quad & 1, cr, sr)
    cv = np.where(quad & 1, sr, cr)
    sin = np.where(quad & 2, -sv, sv)
    cos = np.where((quad + 1) & 2, -cv, cv)
    assert np.abs(sin - np.sin(x.astype(np.float64))).max() < 6.5e-8
    assert np.abs(cos - np.cos(x.astype(np.float64))).max() < 6.5e-8
