"""Model layers as ``nn.Module``s over the shared data dict.

Counterpart of ``sevennet_exp_tpu/model/layers.py`` for the layers a
7net-0 checkpoint builds. Each layer reads and writes string-keyed
tensors (the reference's AtomGraphDataType) and keeps its parameters as
buffers; ``param_tree()`` returns them in the layout of the layer's JAX
parameter pytree (``w0``, ``weight_nn/w2``, ``si2/w1``, ...), which is
how ``checkpoint.params_from_numpy`` state maps onto the model.

Forces come from autograd with respect to positions; no parameter takes
a gradient on this path, hence buffers rather than ``nn.Parameter``s.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import _keys as KEY
from ..irreps import Irreps
from ..ops.fused_conv import FusedConv, GeomSpec
from ..ops.radial import BesselBasis
from ..ops.scatter import (
    gather_rev,
    half_gather,
    pair_spread,
    scatter_sum,
)
from ..ops.spherical import spherical_harmonics
from ..ops.tensor_product import (
    FullyConnectedNetSpec,
    FullyConnectedTPSpec,
    GateSpec,
    LinearSpec,
    UVUTensorProductSpec,
)

Data = Dict[str, Any]


class ParamGroup(nn.Module):
    """A flat group of named parameter buffers (one JAX pytree dict)."""

    def __init__(self, shapes: Dict[str, Tuple[int, ...]]):
        super().__init__()
        for name, shape in shapes.items():
            self.register_buffer(name, torch.zeros(shape))

    def as_dict(self) -> Dict[str, torch.Tensor]:
        return dict(self.named_buffers(recurse=False))


def geom_packed_ok(model) -> bool:
    """Whether a model can run its convolutions geometry-fused: every
    convolution carries a GeomSpec and takes the fused conv. Engines ask
    once per instance."""
    convs = [layer for layer in model.layers.values()
             if isinstance(layer, IrrepsConvolution)]
    return bool(convs) and all(
        layer.geom is not None and layer._fused_eligible()
        for layer in convs)


class EdgeEmbedding(nn.Module):
    """EDGE_VEC -> EDGE_LENGTH, EDGE_EMBEDDING (Bessel * envelope * mask),
    EDGE_ATTR (real SH). Reference sevenn/nn/edge_embedding.py:190-217.
    Always publishes EDGE_BESSEL_COEFFS; with EDGE_GEOM_PACKED set it
    computes nothing else (the convolutions do, in-kernel)."""

    def __init__(self, basis: BesselBasis, cutoff_fn, lmax_edge: int,
                 parity: int, normalize_sph: bool = True):
        super().__init__()
        self.basis, self.cutoff_fn = basis, cutoff_fn
        self.lmax_edge, self.parity = lmax_edge, parity
        self.normalize_sph = normalize_sph
        self.register_buffer('coeffs', basis.init()['coeffs'])

    def param_tree(self):
        return {'coeffs': self.coeffs}

    @property
    def irreps_out(self) -> Irreps:
        return Irreps.spherical_harmonics(self.lmax_edge, self.parity)

    def forward(self, data: Data) -> Data:
        data[KEY.EDGE_BESSEL_COEFFS] = self.coeffs
        if data.get(KEY.EDGE_GEOM_PACKED):
            return data
        rvec = data[KEY.EDGE_VEC]
        r = torch.sqrt(torch.sum(rvec * rvec, dim=-1))
        data[KEY.EDGE_LENGTH] = r
        emb = (self.basis.apply({'coeffs': self.coeffs}, r)
               * self.cutoff_fn.apply(r)[..., None])
        if KEY.EDGE_MASK in data:
            emb = emb * data[KEY.EDGE_MASK][..., None]
        data[KEY.EDGE_EMBEDDING] = emb
        data[KEY.EDGE_ATTR] = spherical_harmonics(
            self.lmax_edge, rvec, normalize=self.normalize_sph,
            normalization='component')
        return data


class OnehotEmbedding(nn.Module):
    """Type index -> one-hot (reference sevenn/nn/node_embedding.py). A
    negative index (a pad atom of a padded batch: Z = 0 maps to -1) gives
    a row of zeros."""

    def __init__(self, num_classes: int):
        super().__init__()
        self.num_classes = num_classes

    def forward(self, data: Data) -> Data:
        inp = data[KEY.NODE_FEATURE]
        idx = inp.long()
        embd = (F.one_hot(idx.clamp(min=0), self.num_classes)
                * (idx >= 0)[:, None]).to(torch.float32)
        data[KEY.NODE_FEATURE] = embd
        data[KEY.NODE_ATTR] = embd
        data[KEY.ATOM_TYPE] = inp
        return data


class IrrepsLinear(nn.Module):
    """e3nn o3.Linear on a data key (reference sevenn/nn/linear.py)."""

    def __init__(self, spec: LinearSpec, key_in: str,
                 key_out: Optional[str] = None):
        super().__init__()
        self.spec, self.key_in, self.key_out = spec, key_in, key_out
        self.p = ParamGroup(spec.param_shapes())

    def param_tree(self):
        return self.p.as_dict()

    def forward(self, data: Data) -> Data:
        data[self.key_out or self.key_in] = self.spec.apply(
            self.p.as_dict(), data[self.key_in])
        return data


class SelfConnectionIntro(nn.Module):
    """FCTP(x, node_attr) -> SELF_CONNECTION_TEMP ('nequip' type,
    reference sevenn/nn/self_connection.py:10-64)."""

    def __init__(self, spec: FullyConnectedTPSpec):
        super().__init__()
        self.spec = spec
        self.p = ParamGroup(spec.param_shapes())

    def param_tree(self):
        return self.p.as_dict()

    def forward(self, data: Data) -> Data:
        data[KEY.SELF_CONNECTION_TEMP] = self.spec.apply(
            self.p.as_dict(), data[KEY.NODE_FEATURE], data[KEY.NODE_ATTR])
        return data


class SelfConnectionLinearIntro(nn.Module):
    """Linear(x) -> SELF_CONNECTION_TEMP ('linear' type, used by 7net-0;
    reference self_connection.py:68-108)."""

    def __init__(self, spec: LinearSpec):
        super().__init__()
        self.spec = spec
        self.p = ParamGroup(spec.param_shapes())

    def param_tree(self):
        return self.p.as_dict()

    def forward(self, data: Data) -> Data:
        data[KEY.SELF_CONNECTION_TEMP] = self.spec.apply(
            self.p.as_dict(), data[KEY.NODE_FEATURE])
        return data


class SelfConnectionOutro(nn.Module):
    """x += SELF_CONNECTION_TEMP (reference self_connection.py:112-128)."""

    def forward(self, data: Data) -> Data:
        data[KEY.NODE_FEATURE] = (data[KEY.NODE_FEATURE]
                                  + data.pop(KEY.SELF_CONNECTION_TEMP))
        return data


class _ChunkedConvFn(torch.autograd.Function):
    """The convolution of one layer as a loop over row chunks of the dense
    grid (counterpart of ``conv_scan`` in the JAX ``_apply_geom_packed``
    and ``EDGE_FEAT_PACKED`` branches). ``feats`` are the per-edge inputs
    that take a gradient: (vec,) geometry-fused (``coeffs`` given) or
    (sh, emb).

    Forward: per chunk gather ``x[src_c]``, run the fused conv forward,
    keep the chunk's node rows. Saves x and the per-edge inputs, never
    the gathered rows. Backward: per chunk gather again, run the fused
    conv backward and keep dxg in one stacked (E, d1) buffer (``rev``
    crosses chunks, so the x cotangent needs every chunk's dxg), then

        dx[v] = sum over v's grid rows of dxg[rev]

    chunk by chunk: scatter-free, and the buffer dies with the call.
    First order only: the mask scale and the weights get no gradient."""

    @staticmethod
    def forward(ctx, conv, chunk_rows, src, rev, ms, coeffs, n_mlp, x,
                *rest):
        n_feats = 1 if coeffs is not None else 2
        feats, ws = rest[:n_feats], rest[n_feats:]
        ctx.conv, ctx.chunk_rows, ctx.n_mlp = conv, chunk_rows, n_mlp
        ctx.n_feats = n_feats
        ctx.save_for_backward(src, rev, ms, coeffs, x, *rest)
        mlp_ws, si2_ws = ws[:n_mlp], ws[n_mlp:]
        outs = []
        for c0 in range(0, src.shape[0], chunk_rows):
            c1 = min(c0 + chunk_rows, src.shape[0])
            xg = x[src[c0:c1]]
            feats_c = [f[c0:c1] for f in feats]
            if coeffs is not None:
                outs.append(conv.geom_forward(xg, *feats_c, ms[c0:c1],
                                              coeffs, mlp_ws, si2_ws))
            else:
                outs.append(conv.forward(xg, *feats_c, ms[c0:c1], mlp_ws,
                                         si2_ws))
        return torch.cat(outs)

    @staticmethod
    def backward(ctx, g):
        src, rev, ms, coeffs, x, *rest = ctx.saved_tensors
        conv, chunk_rows, n_mlp = ctx.conv, ctx.chunk_rows, ctx.n_mlp
        feats, ws = rest[:ctx.n_feats], rest[ctx.n_feats:]
        mlp_ws, si2_ws = tuple(ws[:n_mlp]), tuple(ws[n_mlp:])
        rows, dd = src.shape[0], conv.agg_d
        chunks = [(c0, min(c0 + chunk_rows, rows))
                  for c0 in range(0, rows, chunk_rows)]
        dxg_all = x.new_empty((rows, conv.d1))
        dfeats = [torch.empty_like(f) for f in feats]
        for c0, c1 in chunks:
            xg = x[src[c0:c1]]
            g_c = g[c0 // dd:c1 // dd]
            feats_c = [f[c0:c1] for f in feats]
            if coeffs is not None:
                got = conv.geom_backward(g_c, xg, *feats_c, ms[c0:c1],
                                         coeffs, mlp_ws, si2_ws)
            else:
                got = conv.backward(g_c, xg, *feats_c, ms[c0:c1], mlp_ws,
                                    si2_ws)
            dxg_all[c0:c1] = got[0]
            for d, o in zip(dfeats, got[1:]):
                d[c0:c1] = o
            del xg, got
        dx = x.new_empty((rows // dd, conv.d1))
        for c0, c1 in chunks:
            dx[c0 // dd:c1 // dd] = dxg_all[rev[c0:c1]].reshape(
                -1, dd, conv.d1).sum(1)
        return (None,) * 7 + (dx[:x.shape[0]], *dfeats) + (None,) * len(ws)


class IrrepsConvolution(nn.Module):
    """Message passing + self_interaction_2, on the dense neighbor grid or
    on a plain edge list.

    Reference semantics (sevenn/nn/convolution.py:29-137 and
    interaction_blocks.py:78-84): msg = TP(x[src], Y(r); MLP(radial)),
    x' = linear(sum over the atom's edges of msg / denominator).
    With an si2 linear, a 2-hidden-layer MLP and no si2 bias, the block
    runs as one fused call (``ops/fused_conv``: CUDA kernels on the
    card, the plain chain on the CPU); otherwise as the plain chain.

    With EDGE_REV and EDGE_DENSE_D in the data the edges follow the dense
    grid (the MD engine), and the sum over an atom's edges is a
    reshape-sum. Switches in the data select the execution there (the
    engine sets them), in this order of priority:
    CONV_CHUNK_ROWS > 0 runs the fused conv chunk by chunk
    (``_ChunkedConvFn``: large systems, the gathered rows of one chunk at
    a time); EDGE_GEOM_PACKED runs it geometry-fused, from EDGE_VEC
    and EDGE_BESSEL_COEFFS instead of EDGE_ATTR and EDGE_EMBEDDING;
    EDGE_HALF + EDGE_PAIR run the radial MLP once per edge pair on the
    half list, outside the fused conv, which then takes the weights
    ready-made (``_half_mlp_w``, ``_rows_to_nodes_extw``). The chunked
    path does not consult the half list (as in the JAX package).

    Without them the edges are a plain list in any order (the
    calculator): x[src] is a plain gather, the fused conv returns one row
    per edge (``agg_d = 0``) and ``scatter_sum`` adds the rows onto the
    destination atoms.
    """

    def __init__(self, tp: UVUTensorProductSpec,
                 weight_nn: FullyConnectedNetSpec, si2: Optional[LinearSpec],
                 denominator: float, geom: Optional[GeomSpec] = None):
        super().__init__()
        self.tp, self.weight_nn, self.si2 = tp, weight_nn, si2
        self.geom = geom
        self.register_buffer('denominator',
                             torch.tensor([denominator], dtype=torch.float32))
        self.weight_nn_p = ParamGroup(weight_nn.param_shapes())
        self.si2_p = ParamGroup(si2.param_shapes()) if si2 else None
        self._fused = {}    # (grid degree D, ext_w) -> FusedConv

    def param_tree(self):
        tree = {'weight_nn': self.weight_nn_p.as_dict(),
                'denominator': self.denominator}
        if self.si2_p is not None:
            tree['si2'] = self.si2_p.as_dict()
        return tree

    def _fused_eligible(self) -> bool:
        return (self.si2 is not None and len(self.weight_nn.hs) == 4
                and not self.si2.biases)

    def _geom_eligible(self, data: Data) -> bool:
        return (self.geom is not None and KEY.EDGE_BESSEL_COEFFS in data
                and KEY.EDGE_VEC in data and self._fused_eligible())

    def _conv(self, dd: int, ext_w: bool = False) -> FusedConv:
        conv = self._fused.get((dd, ext_w))
        if conv is None:
            conv = self._fused[dd, ext_w] = FusedConv(
                self.tp, self.weight_nn, self.si2, dd,
                geom=None if ext_w else self.geom, ext_w=ext_w)
        return conv

    def _weights(self):
        mlp = self.weight_nn_p.as_dict()
        si2 = self.si2_p.as_dict()
        return (tuple(mlp[f'w{i}'] for i in range(len(mlp))),
                tuple(si2[f'w{n}'] for n in range(len(si2))))

    def _rows_to_nodes(self, xg, sh, emb, scale, dd):
        if self._fused_eligible():
            return self._conv(dd)(xg, sh.contiguous(), emb.contiguous(),
                                  scale.contiguous(), *self._weights())
        w = self.weight_nn.apply(self.weight_nn_p.as_dict(), emb) * scale
        message = self.tp.apply(xg, sh, w)
        agg = message.reshape(
            (message.shape[0] // dd, dd) + message.shape[1:]).sum(1)
        if self.si2 is None:
            return agg
        return self.si2.apply(self.si2_p.as_dict(), agg, skip_bias=True)

    def _rows_to_nodes_extw(self, xg, sh, w_eff, dd):
        """External-weight variant of ``_rows_to_nodes``: the per-edge
        radial weights (already mask/denominator-scaled) come from
        outside, and the fused conv runs the CG contraction, the
        aggregation and si2 only."""
        return self._conv(dd, ext_w=True)(
            xg, sh.contiguous(), w_eff.contiguous(), self._weights()[1])

    def _half_mlp_w(self, data: Data, emb, scale, rev):
        """Per-edge radial weights by the half list: the MLP (one
        ``torch.matmul`` chain, fp32) on the E/2 representative rows --
        |r| is the same for an edge and its reverse, so their emb rows
        are equal bit for bit -- spread to both directed edges by a
        gather with a scatter-free backward, then mask/denominator-scaled.
        Halves the radial MLP's operations."""
        half, pair = data[KEY.EDGE_HALF], data[KEY.EDGE_PAIR]
        emb_half = half_gather(emb, half, pair)
        w_half = self.weight_nn.apply(self.weight_nn_p.as_dict(), emb_half)
        return pair_spread(w_half, pair, half, rev) * scale

    def _rows_to_nodes_geom(self, xg, vec, coeffs, scale, dd):
        """Geometry-fused variant of ``_rows_to_nodes``: raw edge vectors
        in, Bessel/cutoff/SH computed inside the fused conv."""
        return self._conv(dd).apply_geom(
            xg, vec.contiguous(), scale.contiguous(), coeffs,
            *self._weights())

    def _rows_to_nodes_chunked(self, x, src, rev, feats, coeffs, scale, dd,
                               chunk_rows):
        if not self._fused_eligible():
            raise NotImplementedError(
                'the chunked convolution runs the fused conv only')
        if chunk_rows % dd:
            raise ValueError(f'chunk of {chunk_rows} rows is not a whole '
                             f'number of atoms (D = {dd})')
        mlp_ws, si2_ws = self._weights()
        return _ChunkedConvFn.apply(
            self._conv(dd), chunk_rows, src, rev, scale.contiguous(), coeffs,
            len(mlp_ws), x, *(f.contiguous() for f in feats), *mlp_ws,
            *si2_ws)

    def _edge_list(self, x, edge_dst, edge_src, sh, emb, scale):
        """The plain edge-list branch: edge rows, then a scatter-add onto
        the destination atoms (``index_add_``; on CUDA by atomics, in no
        fixed order)."""
        xg = x[edge_src]
        n = x.shape[0]
        if self._fused_eligible():
            y = self._conv(0)(xg, sh.contiguous(), emb.contiguous(),
                              scale.contiguous(), *self._weights())
            return scatter_sum(y, edge_dst, n)
        w = self.weight_nn.apply(self.weight_nn_p.as_dict(), emb) * scale
        agg = scatter_sum(self.tp.apply(xg, sh, w), edge_dst, n)
        if self.si2 is None:
            return agg
        return self.si2.apply(self.si2_p.as_dict(), agg, skip_bias=True)

    def forward(self, data: Data) -> Data:
        x = data[KEY.NODE_FEATURE]
        edge_idx = data[KEY.EDGE_IDX]
        rev = data.get(KEY.EDGE_REV)
        dd = data.get(KEY.EDGE_DENSE_D)
        dense = rev is not None and dd is not None
        denom = self.denominator.to(x.dtype)
        rows = edge_idx.shape[1]
        scale = x.new_ones((rows, 1)) / denom
        if KEY.EDGE_MASK in data:
            scale = scale * data[KEY.EDGE_MASK][..., None]
        geom = bool(data.get(KEY.EDGE_GEOM_PACKED))
        if geom and not (dense and self._geom_eligible(data)):
            raise ValueError('EDGE_GEOM_PACKED is set but this convolution '
                             'cannot run geometry-fused')
        coeffs = data[KEY.EDGE_BESSEL_COEFFS].to(x.dtype) if geom else None
        feats = ((data[KEY.EDGE_VEC],) if geom else
                 (data[KEY.EDGE_ATTR], data[KEY.EDGE_EMBEDDING]))
        chunk_rows = data.get(KEY.CONV_CHUNK_ROWS)
        if chunk_rows:
            if not dense:
                raise ValueError('the chunked convolution needs the dense '
                                 'neighbor grid (EDGE_REV + EDGE_DENSE_D)')
            out = self._rows_to_nodes_chunked(x, edge_idx[1], rev, feats,
                                              coeffs, scale, dd, chunk_rows)
        elif dense:
            xg = gather_rev(x, edge_idx[1], rev, dd)
            if geom:
                out = self._rows_to_nodes_geom(xg, feats[0], coeffs, scale,
                                               dd)
            elif (data.get(KEY.EDGE_HALF) is not None
                    and self._fused_eligible()):
                w_eff = self._half_mlp_w(data, feats[1], scale, rev)
                out = self._rows_to_nodes_extw(xg, feats[0], w_eff, dd)
            else:
                out = self._rows_to_nodes(xg, *feats, scale, dd)
        else:
            out = self._edge_list(x, edge_idx[0], edge_idx[1], *feats, scale)
        out = out[:x.shape[0]]
        if self.si2 is not None:
            bias = self.si2.bias_vector(self.si2_p.as_dict(), out.dtype)
            if bias is not None:
                out = out + bias
        data[KEY.NODE_FEATURE] = out
        return data


class EquivariantGate(nn.Module):
    """Gate nonlinearity (reference sevenn/nn/equivariant_gate.py)."""

    def __init__(self, spec: GateSpec):
        super().__init__()
        self.spec = spec

    def forward(self, data: Data) -> Data:
        data[KEY.NODE_FEATURE] = self.spec.apply(data[KEY.NODE_FEATURE])
        return data


class Rescale(nn.Module):
    """atomic_E = scaled * scale + shift (reference sevenn/nn/scale.py)."""

    def __init__(self, shift: float, scale: float):
        super().__init__()
        self.register_buffer('shift', torch.tensor([shift]))
        self.register_buffer('scale', torch.tensor([scale]))

    def param_tree(self):
        return {'shift': self.shift, 'scale': self.scale}

    def forward(self, data: Data) -> Data:
        data[KEY.ATOMIC_ENERGY] = (data[KEY.SCALED_ATOMIC_ENERGY]
                                   * self.scale + self.shift)
        return data


class SpeciesWiseRescale(nn.Module):
    """Per-species shift/scale indexed by ATOM_TYPE
    (reference sevenn/nn/scale.py:60-161)."""

    def __init__(self, shift, scale):
        super().__init__()
        self.register_buffer('shift', torch.tensor(list(shift)))
        self.register_buffer('scale', torch.tensor(list(scale)))

    def param_tree(self):
        return {'shift': self.shift, 'scale': self.scale}

    def forward(self, data: Data) -> Data:
        idx = data[KEY.ATOM_TYPE].long()
        data[KEY.ATOMIC_ENERGY] = (
            data[KEY.SCALED_ATOMIC_ENERGY] * self.scale[idx][..., None]
            + self.shift[idx][..., None])
        return data


class AtomReduce(nn.Module):
    """Masked per-graph sum of atomic energies
    (reference sevenn/nn/linear.py:104-141). The sum runs in float64: an
    ``index_add_`` of 97k float32 energies into one bucket adds them one
    by one and drifts by ~1 eV (1e-5 eV/atom)."""

    def forward(self, data: Data) -> Data:
        src = data[KEY.ATOMIC_ENERGY][..., 0]
        if KEY.NODE_MASK in data:
            src = src * data[KEY.NODE_MASK]
        num_graphs = data[KEY.NUM_ATOMS].shape[0]
        data[KEY.PRED_TOTAL_ENERGY] = scatter_sum(
            src.double(), data[KEY.BATCH].long(), num_graphs).to(src.dtype)
        return data
