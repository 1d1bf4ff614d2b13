"""Model layers as ``nn.Module``s over the shared data dict.

Counterpart of ``sevennet_exp_tpu/model/layers.py``: the layers a
7net-0 checkpoint builds, and the other forms of the family (per-layer
cutoffs, modalities, the FCN readout). Each layer reads and writes string-keyed
tensors (the reference's AtomGraphDataType) and keeps its parameters as
buffers; ``param_tree()`` returns them in the layout of the layer's JAX
parameter pytree (``w0``, ``weight_nn/w2``, ``si2/w1``, ...), which is
how ``checkpoint.params_from_numpy`` state maps onto the model.

Forces come from autograd with respect to positions; no parameter takes
a gradient on that path, hence buffers rather than ``nn.Parameter``s (the
trainer sets ``requires_grad`` on the trainable ones). ``init(generator)``
draws a layer's parameters as the JAX ``init(key)`` does, same
distributions and scales (not the same bits), and returns them with the
trainable mask in the ``param_tree`` layout.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import _keys as KEY
from ..irreps import Irreps
from ..ops.fused_conv import (
    CG_MODE_KEY,
    USE_KERNELS_KEY,
    FusedConv,
    GeomSpec,
)
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

    def init(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """Weights (``w*``) from N(0, 1), biases (``b*``) zero: the JAX
        ``LinearSpec``, ``FullyConnectedTPSpec`` and
        ``FullyConnectedNetSpec.init``."""
        return {name: (torch.zeros(b.shape) if name.startswith('b')
                       else torch.randn(b.shape, generator=generator))
                for name, b in self.as_dict().items()}


def _linear_init(group: ParamGroup, generator: torch.Generator):
    p = group.init(generator)
    return p, {k: True for k in p}


def geom_packed_ok(model) -> bool:
    """Whether a model can run its convolutions geometry-fused: every
    convolution carries a GeomSpec and its kernels take it on the dense
    grid. Engines ask once per instance."""
    convs = [layer for layer in model.layers.values()
             if isinstance(layer, IrrepsConvolution)]
    return bool(convs) and all(
        layer.geom is not None and layer.kernel_refusal(1) is None
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

    def init(self, generator):
        return self.basis.init(), {'coeffs': self.basis.trainable}

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


class MultiCutoffEdgeEmbedding(nn.Module):
    """Per-layer cutoff radii (JAX ``MultiCutoffEdgeEmbedding``, reference
    edge_embedding.py:220-257). One static edge list; per unique cutoff c
    a masked radial embedding ``edge_embedding{c}`` and its mask
    ``edge_mask{c}`` (r <= c, times EDGE_MASK), which the convolutions at
    cutoff c fold into their mask scale, so a message beyond c is exactly
    zero. The spherical harmonics (EDGE_ATTR) are shared. Such a model is
    never geometry-fused: no convolution carries a GeomSpec."""

    def __init__(self, bases, cutoff_fns, lmax_edge: int, parity: int,
                 normalize_sph: bool = True):
        super().__init__()
        self.bases, self.cutoff_fns = tuple(bases), tuple(cutoff_fns)
        self.lmax_edge, self.parity = lmax_edge, parity
        self.normalize_sph = normalize_sph
        for i, basis in enumerate(self.bases):
            self.register_buffer(f'coeffs_{i}', basis.init()['coeffs'])

    def _coeffs(self, i: int) -> torch.Tensor:
        return getattr(self, f'coeffs_{i}')

    def param_tree(self):
        return {f'c{b.cutoff}': {'coeffs': self._coeffs(i)}
                for i, b in enumerate(self.bases)}

    def init(self, generator):
        return ({f'c{b.cutoff}': b.init() for b in self.bases},
                {f'c{b.cutoff}': {'coeffs': b.trainable}
                 for b in self.bases})

    @property
    def irreps_out(self) -> Irreps:
        return Irreps.spherical_harmonics(self.lmax_edge, self.parity)

    def forward(self, data: Data) -> Data:
        rvec = data[KEY.EDGE_VEC]
        r = torch.sqrt(torch.sum(rvec * rvec, dim=-1))
        data[KEY.EDGE_LENGTH] = r
        base_mask = data.get(KEY.EDGE_MASK)
        for i, (basis, env) in enumerate(zip(self.bases, self.cutoff_fns)):
            c = basis.cutoff
            mask = (r <= c).to(r.dtype)
            if base_mask is not None:
                mask = mask * base_mask
            emb = (basis.apply({'coeffs': self._coeffs(i)}, r)
                   * env.apply(r)[..., None] * mask[..., None])
            data[KEY.EDGE_EMBEDDING + str(c)] = emb
            data[KEY.EDGE_MASK + str(c)] = mask
        data[KEY.EDGE_ATTR] = spherical_harmonics(
            self.lmax_edge, rvec, normalize=self.normalize_sph,
            normalization='component')
        return data


def _one_hot(idx: torch.Tensor, num_classes: int, dtype) -> torch.Tensor:
    """One-hot rows; a negative index gives a row of zeros."""
    idx = idx.long()
    return (F.one_hot(idx.clamp(min=0), num_classes)
            * (idx >= 0)[..., None]).to(dtype)


class OnehotEmbedding(nn.Module):
    """Type index -> one-hot (reference sevenn/nn/node_embedding.py). A
    negative index (a pad atom of a padded batch: Z = 0 maps to -1) gives
    a row of zeros. The modality one-hot (``one_hot_modality``) is the
    same layer on MODAL_TYPE, written to MODAL_ATTR and nowhere else."""

    def __init__(self, num_classes: int, key_x: str = KEY.NODE_FEATURE,
                 key_out: Optional[str] = None,
                 key_save: Optional[str] = KEY.ATOM_TYPE,
                 key_additional: Optional[str] = KEY.NODE_ATTR):
        super().__init__()
        self.num_classes = num_classes
        self.key_x, self.key_out = key_x, key_out
        self.key_save, self.key_additional = key_save, key_additional

    def forward(self, data: Data) -> Data:
        inp = data[self.key_x]
        embd = _one_hot(inp, self.num_classes, torch.float32)
        data[self.key_out or self.key_x] = embd
        if self.key_additional is not None:
            data[self.key_additional] = embd
        if self.key_save is not None:
            data[self.key_save] = inp
        return data


class IrrepsLinear(nn.Module):
    """e3nn o3.Linear on a data key (reference sevenn/nn/linear.py). With
    ``num_modalities`` > 1 the structure's modality one-hot is appended to
    the input as n x 0e (reference linear.py:65-101): per graph, spread to
    the graph's atoms by BATCH."""

    def __init__(self, spec: LinearSpec, key_in: str,
                 key_out: Optional[str] = None, num_modalities: int = 0):
        super().__init__()
        self.spec, self.key_in, self.key_out = spec, key_in, key_out
        self.num_modalities = int(num_modalities)
        self.p = ParamGroup(spec.param_shapes())

    def param_tree(self):
        return self.p.as_dict()

    def init(self, generator):
        return _linear_init(self.p, generator)

    def forward(self, data: Data) -> Data:
        x = data[self.key_in]
        if self.num_modalities > 1:
            modal = _one_hot(data[KEY.MODAL_TYPE], self.num_modalities,
                             x.dtype)
            if modal.ndim == x.ndim:                # per graph -> per atom
                modal = modal[data[KEY.BATCH].long()]
            x = torch.cat([x, modal], dim=-1)
        data[self.key_out or self.key_in] = self.spec.apply(
            self.p.as_dict(), x)
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

    def init(self, generator):
        return _linear_init(self.p, generator)

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

    def init(self, generator):
        return _linear_init(self.p, generator)

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
    With an si2 linear, a 2-hidden-layer MLP and no si2 bias (the JAX
    rule), and a layer the kernels take (``FusedConv.kernel_refusal``,
    decided from the shapes when the conv is built), the block runs as
    one fused call (``ops/fused_conv``: CUDA kernels on the card, the
    plain chain on the CPU); otherwise as the plain chain, on any device.
    ``USE_KERNELS_KEY`` = False in the data sends every layer down the
    plain chain (the trainer: it needs gradients of gradients, which only
    the plain chain has). ``kernel_refusal`` says why a layer is refused.

    With EDGE_REV and EDGE_DENSE_D in the data the edges follow the dense
    grid (the MD engine), and the sum over an atom's edges is a
    reshape-sum. Switches in the data select the execution there (the
    engine sets them), in this order of priority:
    CONV_CHUNK_ROWS > 0 runs the convolution chunk by chunk (large
    systems, the gathered rows of one chunk at a time: the fused conv by
    ``_ChunkedConvFn``, a refused layer or any layer under
    ``USE_KERNELS_KEY`` False the plain chain under checkpointing);
    EDGE_GEOM_PACKED runs it geometry-fused, from EDGE_VEC
    and EDGE_BESSEL_COEFFS instead of EDGE_ATTR and EDGE_EMBEDDING;
    EDGE_HALF + EDGE_PAIR run the radial MLP once per edge pair on the
    half list, outside the fused conv, which then takes the weights
    ready-made (``_half_mlp_w``, ``_rows_to_nodes_extw``; its own refusal,
    ``kernel_refusal(dd, ext_w=True)``, decides this branch). The chunked
    path does not consult the half list (as in the JAX package).
    ``CG_MODE_KEY`` = 'terms' makes the fused conv launch its independently
    derived ``terms`` kernels (dense grid, chunked with shared sh/emb, or
    edge list); it excludes the geometry-fused and the half-list branches.

    Without them the edges are a plain list in any order (the
    calculator): x[src] is a plain gather, the fused conv returns one row
    per edge (``agg_d = 0``) and ``scatter_sum`` adds the rows onto the
    destination atoms.

    ``key_weight_input`` / ``key_mask`` name the radial embedding and the
    edge mask the layer reads: under per-layer cutoffs
    (``MultiCutoffEdgeEmbedding``) its cutoff's ``edge_embedding{c}`` and
    ``edge_mask{c}``; the mask goes into the mask scale on every branch, so
    a message beyond c is exactly zero. With ``si2`` None (the modal split,
    a separate node-level ``self_interaction_2`` follows) the layer is
    refused by the kernels, as in JAX, and runs the plain chain.
    """

    def __init__(self, tp: UVUTensorProductSpec,
                 weight_nn: FullyConnectedNetSpec, si2: Optional[LinearSpec],
                 denominator: float, geom: Optional[GeomSpec] = None,
                 train_denominator: bool = False,
                 key_weight_input: str = KEY.EDGE_EMBEDDING,
                 key_mask: str = KEY.EDGE_MASK):
        super().__init__()
        self.tp, self.weight_nn, self.si2 = tp, weight_nn, si2
        self.geom = geom
        self.key_weight_input, self.key_mask = key_weight_input, key_mask
        self.train_denominator = bool(train_denominator)
        self.register_buffer('denominator',
                             torch.tensor([denominator], dtype=torch.float32))
        self.weight_nn_p = ParamGroup(weight_nn.param_shapes())
        self.si2_p = ParamGroup(si2.param_shapes()) if si2 else None
        self._fused = {}    # (grid degree D, ext_w, cg_mode) -> FusedConv

    def param_tree(self):
        tree = {'weight_nn': self.weight_nn_p.as_dict(),
                'denominator': self.denominator}
        if self.si2_p is not None:
            tree['si2'] = self.si2_p.as_dict()
        return tree

    def init(self, generator):
        p = {'weight_nn': self.weight_nn_p.init(generator),
             'denominator': self.denominator.detach().clone()}
        mask = {'weight_nn': {k: True for k in p['weight_nn']},
                'denominator': self.train_denominator}
        if self.si2_p is not None:
            p['si2'] = self.si2_p.init(generator)
            mask['si2'] = {k: True for k in p['si2']}
        return p, mask

    def _fused_eligible(self) -> bool:
        return (self.si2 is not None and len(self.weight_nn.hs) == 4
                and not self.si2.biases)

    def kernel_refusal(self, dd: int = 0, cg_mode: str = 'cmshared',
                       ext_w: bool = False) -> Optional[str]:
        """Why this convolution runs the plain chain on a grid of degree
        ``dd`` (0: the plain edge list) under ``cg_mode``, or with
        ``ext_w`` on the half list, or None when the fused conv takes it:
        the JAX rule, then the kernels' own (``FusedConv.kernel_refusal``).
        From the shapes alone."""
        if not self._fused_eligible():
            return ('no fused conv: it needs an si2 linear without bias and '
                    'a radial MLP of two hidden layers')
        return self._conv(dd, ext_w, cg_mode).kernel_refusal

    def _conv(self, dd: int, ext_w: bool = False,
              cg_mode: str = 'cmshared') -> FusedConv:
        conv = self._fused.get((dd, ext_w, cg_mode))
        if conv is None:
            terms = cg_mode == 'terms'
            conv = self._fused[dd, ext_w, cg_mode] = FusedConv(
                self.tp, self.weight_nn, self.si2, dd,
                geom=None if ext_w or terms else self.geom, ext_w=ext_w,
                cg_mode=cg_mode)
        return conv

    def _weights(self):
        mlp = self.weight_nn_p.as_dict()
        si2 = self.si2_p.as_dict()
        return (tuple(mlp[f'w{i}'] for i in range(len(mlp))),
                tuple(si2[f'w{n}'] for n in range(len(si2))))

    def _rows_to_nodes(self, xg, sh, emb, scale, dd, cg_mode, fused):
        if fused:
            return self._conv(dd, cg_mode=cg_mode)(
                xg, sh.contiguous(), emb.contiguous(), scale.contiguous(),
                *self._weights())
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

    def _plain_chunk(self, x, src_c, sh_c, emb_c, scale_c, dd):
        return self._rows_to_nodes(x[src_c], sh_c, emb_c, scale_c, dd,
                                   'cmshared', False)

    def _rows_to_nodes_chunked(self, x, src, rev, feats, coeffs, scale, dd,
                               chunk_rows, cg_mode, fused):
        """The convolution chunk by chunk: the fused conv
        (``_ChunkedConvFn``), or, for a layer the kernels refuse or with
        ``use_kernels`` off, the plain chain (JAX's per-chunk scan of
        ``jax.checkpoint`` pieces): per chunk of whole atoms, the gather
        and the plain chain under ``torch.utils.checkpoint``, so that one
        chunk's activations live at a time; the backward runs each chunk
        again, and x's gradient goes through the gather's own backward
        (autograd to any order, as the whole-array plain chain)."""
        if chunk_rows % dd:
            raise ValueError(f'chunk of {chunk_rows} rows is not a whole '
                             f'number of atoms (D = {dd})')
        if not fused:
            sh, emb = feats
            return torch.cat([
                checkpoint(self._plain_chunk, x, src[c0:c0 + chunk_rows],
                           sh[c0:c0 + chunk_rows], emb[c0:c0 + chunk_rows],
                           scale[c0:c0 + chunk_rows], dd,
                           use_reentrant=False)
                for c0 in range(0, src.shape[0], chunk_rows)])
        mlp_ws, si2_ws = self._weights()
        return _ChunkedConvFn.apply(
            self._conv(dd, cg_mode=cg_mode), chunk_rows, src, rev,
            scale.contiguous(), coeffs,
            len(mlp_ws), x, *(f.contiguous() for f in feats), *mlp_ws,
            *si2_ws)

    def _edge_list(self, x, edge_dst, edge_src, sh, emb, scale, cg_mode,
                   fused):
        """The plain edge-list branch: edge rows, then a scatter-add onto
        the destination atoms (``index_add_``; on CUDA by atomics, in no
        fixed order)."""
        xg = x[edge_src]
        n = x.shape[0]
        if fused:
            y = self._conv(0, cg_mode=cg_mode)(
                xg, sh.contiguous(), emb.contiguous(), scale.contiguous(),
                *self._weights())
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
        if self.key_mask in data:
            scale = scale * data[self.key_mask][..., None]
        geom = bool(data.get(KEY.EDGE_GEOM_PACKED))
        cg_mode = data.get(CG_MODE_KEY, 'cmshared')
        half = data.get(KEY.EDGE_HALF) is not None
        if cg_mode == 'terms' and (geom or half):
            raise ValueError("cg_mode 'terms' runs neither geometry-fused "
                             'nor on the half list')
        kernels = bool(data.get(USE_KERNELS_KEY, True))
        fused = (kernels
                 and self.kernel_refusal(dd if dense else 0, cg_mode) is None)
        if geom and not (dense and fused and self.geom is not None
                         and KEY.EDGE_BESSEL_COEFFS in data
                         and KEY.EDGE_VEC in data):
            raise ValueError('EDGE_GEOM_PACKED is set but this convolution '
                             'cannot run geometry-fused')
        coeffs = data[KEY.EDGE_BESSEL_COEFFS].to(x.dtype) if geom else None
        feats = ((data[KEY.EDGE_VEC],) if geom else
                 (data[KEY.EDGE_ATTR], data[self.key_weight_input]))
        chunk_rows = data.get(KEY.CONV_CHUNK_ROWS)
        if chunk_rows:
            if not dense:
                raise ValueError('the chunked convolution needs the dense '
                                 'neighbor grid (EDGE_REV + EDGE_DENSE_D)')
            out = self._rows_to_nodes_chunked(x, edge_idx[1], rev, feats,
                                              coeffs, scale, dd, chunk_rows,
                                              cg_mode, fused)
        elif dense:
            xg = gather_rev(x, edge_idx[1], rev, dd)
            if geom:
                out = self._rows_to_nodes_geom(xg, feats[0], coeffs, scale,
                                               dd)
            elif half and kernels and self.kernel_refusal(
                    dd, ext_w=True) is None:
                w_eff = self._half_mlp_w(data, feats[1], scale, rev)
                out = self._rows_to_nodes_extw(xg, feats[0], w_eff, dd)
            else:
                out = self._rows_to_nodes(xg, *feats, scale, dd, cg_mode,
                                          fused)
        else:
            out = self._edge_list(x, edge_idx[0], edge_idx[1], *feats, scale,
                                  cg_mode, fused)
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

    def __init__(self, shift: float, scale: float,
                 train_shift_scale: bool = False):
        super().__init__()
        self.register_buffer('shift', torch.tensor([shift]))
        self.register_buffer('scale', torch.tensor([scale]))
        self.train_shift_scale = bool(train_shift_scale)

    def param_tree(self):
        return {'shift': self.shift, 'scale': self.scale}

    def init(self, generator):
        return _shift_scale_init(self)

    def forward(self, data: Data) -> Data:
        data[KEY.ATOMIC_ENERGY] = (data[KEY.SCALED_ATOMIC_ENERGY]
                                   * self.scale + self.shift)
        return data


class SpeciesWiseRescale(nn.Module):
    """Per-species shift/scale indexed by ATOM_TYPE
    (reference sevenn/nn/scale.py:60-161)."""

    def __init__(self, shift, scale, train_shift_scale: bool = False):
        super().__init__()
        self.register_buffer('shift', torch.tensor(list(shift)))
        self.register_buffer('scale', torch.tensor(list(scale)))
        self.train_shift_scale = bool(train_shift_scale)

    def param_tree(self):
        return {'shift': self.shift, 'scale': self.scale}

    def init(self, generator):
        return _shift_scale_init(self)

    def forward(self, data: Data) -> Data:
        idx = data[KEY.ATOM_TYPE].long()
        data[KEY.ATOMIC_ENERGY] = (
            data[KEY.SCALED_ATOMIC_ENERGY] * self.scale[idx][..., None]
            + self.shift[idx][..., None])
        return data


class ModalWiseRescale(nn.Module):
    """Per-(modality, species) shift and scale (JAX ``ModalWiseRescale``,
    reference scale.py:165-361): ``shift`` / ``scale`` are (n_modal,
    n_types) where modal-wise, else (n_types,); indexed by MODAL_TYPE
    (per graph, spread to the atoms by BATCH) and ATOM_TYPE."""

    def __init__(self, shift, scale, use_modal_wise_shift: bool = False,
                 use_modal_wise_scale: bool = False,
                 train_shift_scale: bool = False):
        super().__init__()
        self.register_buffer('shift', torch.tensor(shift,
                                                   dtype=torch.float32))
        self.register_buffer('scale', torch.tensor(scale,
                                                   dtype=torch.float32))
        self.use_modal_wise_shift = bool(use_modal_wise_shift)
        self.use_modal_wise_scale = bool(use_modal_wise_scale)
        self.train_shift_scale = bool(train_shift_scale)

    def param_tree(self):
        return {'shift': self.shift, 'scale': self.scale}

    def init(self, generator):
        return _shift_scale_init(self)

    def forward(self, data: Data) -> Data:
        atom_idx = data[KEY.ATOM_TYPE].long()
        modal_idx = data[KEY.MODAL_TYPE].long()
        if modal_idx.ndim > 0 and modal_idx.shape[0] != atom_idx.shape[0]:
            modal_idx = modal_idx[data[KEY.BATCH].long()]
        shift = (self.shift[modal_idx, atom_idx] if self.use_modal_wise_shift
                 else self.shift[atom_idx])
        scale = (self.scale[modal_idx, atom_idx] if self.use_modal_wise_scale
                 else self.scale[atom_idx])
        data[KEY.ATOMIC_ENERGY] = (data[KEY.SCALED_ATOMIC_ENERGY]
                                   * scale[..., None] + shift[..., None])
        return data


class FCNReadout(nn.Module):
    """Scalar MLP readout (JAX ``FCNReadout``, reference
    sevenn/nn/linear.py:145-180): NODE_FEATURE -> SCALED_ATOMIC_ENERGY."""

    def __init__(self, spec: FullyConnectedNetSpec):
        super().__init__()
        self.spec = spec
        self.p = ParamGroup(spec.param_shapes())

    def param_tree(self):
        return self.p.as_dict()

    def init(self, generator):
        return _linear_init(self.p, generator)

    def forward(self, data: Data) -> Data:
        data[KEY.SCALED_ATOMIC_ENERGY] = self.spec.apply(
            self.p.as_dict(), data[KEY.NODE_FEATURE])
        return data


def _shift_scale_init(layer):
    """The built shift and scale (the dataset statistics), trainable with
    ``train_shift_scale``."""
    p = {'shift': layer.shift.detach().clone(),
         'scale': layer.scale.detach().clone()}
    return p, {k: layer.train_shift_scale for k in p}


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
