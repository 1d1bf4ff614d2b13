"""Equivariant primitives in torch: Linear, uvu TensorProduct,
FullyConnectedTP, Gate and the radial FullyConnectedNet.

Counterpart of ``sevennet_exp_tpu/ops/tensor_product.py``. The specs
build the same static metadata (paths, instructions, CG nonzeros) from
the same irreps algebra, and ``apply`` repeats the same arithmetic on
torch tensors. Conventions (e3nn >= 0.5): 'component' irrep
normalization, 'element' path normalization, N(0, 1) stored weights
with the normalization applied in the forward pass.

Layout: features are **ir_mul** -- within each (mul, ir) entry the flat
index is m * mul + u -- exactly as in the JAX package, so parameters
and feature tensors move between the two unchanged.

Frozen copy of ``sevennet_exp_tpu_torch/ops/tensor_product.py`` for the benchmark's
plain reference, which imports nothing of the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from .irreps import Irrep, Irreps, MulIrrep
from .normalize import normalized_activation
from .wigner import wigner_3j

Tensor = torch.Tensor
Params = Dict[str, Tensor]


@dataclass(frozen=True)
class LinearSpec:
    """e3nn o3.Linear over simplified irreps (one path per matching ir)."""
    irreps_in: Irreps
    irreps_out: Irreps
    biases: bool = False
    # per-path: (i_in, i_out, mul_in, mul_out, alpha)
    paths: Tuple[Tuple[int, int, int, int, float], ...] = field(default=None)  # type: ignore

    def __post_init__(self):
        irreps_in = Irreps(self.irreps_in).simplify()
        irreps_out = Irreps(self.irreps_out).simplify()
        object.__setattr__(self, 'irreps_in', irreps_in)
        object.__setattr__(self, 'irreps_out', irreps_out)
        fan_in = [0] * len(irreps_out)
        for j, (_, ir_out) in enumerate(irreps_out):
            for mul_in, ir_in in irreps_in:
                if ir_in == ir_out:
                    fan_in[j] += mul_in
        paths = []
        for i, (mul_in, ir_in) in enumerate(irreps_in):
            for j, (mul_out, ir_out) in enumerate(irreps_out):
                if ir_in == ir_out:
                    alpha = 1.0 / math.sqrt(fan_in[j]) if fan_in[j] > 0 else 0.0
                    paths.append((i, j, mul_in, mul_out, alpha))
        object.__setattr__(self, 'paths', tuple(paths))

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        shapes = {f'w{n}': (mi, mo)
                  for n, (_, _, mi, mo, _) in enumerate(self.paths)}
        if self.biases:
            for j, (mul, ir) in enumerate(self.irreps_out):
                if ir == Irrep(0, 1):
                    shapes[f'b{j}'] = (mul,)
        return shapes

    def apply(self, params: Params, x: Tensor, skip_bias: bool = False) -> Tensor:
        """x: (..., dim) in ir_mul layout; one matmul per path."""
        in_slices = self.irreps_in.slices()
        lead = x.shape[:-1]
        out_blocks: List[Optional[Tensor]] = [None] * len(self.irreps_out)
        for n, (i, j, mi, mo, alpha) in enumerate(self.paths):
            dim = self.irreps_in[i].ir.dim
            xi = x[..., in_slices[i]].reshape(-1, mi)
            w = params[f'w{n}'].to(x.dtype) * alpha
            o = (xi @ w).reshape(lead + (dim, mo))
            out_blocks[j] = o if out_blocks[j] is None else out_blocks[j] + o
        outs = []
        for j, (mul, ir) in enumerate(self.irreps_out):
            blk = out_blocks[j]
            if blk is None:
                blk = x.new_zeros(lead + (ir.dim, mul))
            if (self.biases and not skip_bias and ir == Irrep(0, 1)
                    and f'b{j}' in params):
                blk = blk + params[f'b{j}'].to(x.dtype)
            outs.append(blk.reshape(lead + (mul * ir.dim,)))
        return torch.cat(outs, dim=-1)


@dataclass(frozen=True)
class UVUTensorProductSpec:
    """e3nn TensorProduct(irreps_x, irreps_filter, irreps_mid, 'uvu',
    shared_weights=False, internal_weights=False); instruction order as
    reference sevenn/nn/convolution.py:60-81 (sorted by output slot)."""
    irreps_in1: Irreps
    irreps_in2: Irreps
    irreps_out_filter: Irreps
    irreps_out: Irreps = field(default=None)  # type: ignore
    instructions: Tuple[Tuple[int, int, int], ...] = field(default=None)  # type: ignore
    weight_numel: int = field(default=None)  # type: ignore
    # pre-sort order (the v <= 0.10 checkpoint weight layout; reference
    # scripts/backward_compatibility.py:74-155 sort_old_convolution)
    instructions_unsorted: Tuple[Tuple[int, int, int], ...] = field(default=None)  # type: ignore

    def __post_init__(self):
        irreps_x = Irreps(self.irreps_in1)
        irreps_filter = Irreps(self.irreps_in2)
        keep = Irreps(self.irreps_out_filter)
        instructions = []
        irreps_mid: List[MulIrrep] = []
        weight_numel = 0
        for i, (mul_x, ir_x) in enumerate(irreps_x):
            for j, (_, ir_f) in enumerate(irreps_filter):
                for ir_out in ir_x * ir_f:
                    if ir_out in keep:
                        k = len(irreps_mid)
                        weight_numel += mul_x
                        irreps_mid.append(MulIrrep(mul_x, ir_out))
                        instructions.append((i, j, k))
        srt, p, _ = Irreps(irreps_mid).sort()
        instructions = [(i1, i2, p[k]) for (i1, i2, k) in instructions]
        unsorted = tuple(instructions)
        instructions = sorted(instructions, key=lambda t: t[2])
        object.__setattr__(self, 'irreps_in1', irreps_x)
        object.__setattr__(self, 'irreps_in2', irreps_filter)
        object.__setattr__(self, 'irreps_out', srt)
        object.__setattr__(self, 'instructions', tuple(instructions))
        object.__setattr__(self, 'weight_numel', weight_numel)
        object.__setattr__(self, 'instructions_unsorted', unsorted)

    def alphas(self) -> List[float]:
        """Per-instruction sqrt(alpha), e3nn component/element norm."""
        fan = {}
        for (i1, i2, k) in self.instructions:
            fan[k] = fan.get(k, 0) + self.irreps_in2[i2].mul
        return [math.sqrt((2 * self.irreps_out[k].ir.l + 1) / fan[k])
                for (i1, i2, k) in self.instructions]

    def cg_nonzeros(self):
        """Per instruction: static list of nonzero CG entries (m, n, p, c)."""
        res = []
        for n_i, ((i1, i2, k), a) in enumerate(
                zip(self.instructions, self.alphas())):
            ir1 = self.irreps_in1[i1].ir
            ir2 = self.irreps_in2[i2].ir
            ir3 = self.irreps_out[k].ir
            C = wigner_3j(ir1.l, ir2.l, ir3.l) * a
            nz = tuple(
                (m, n, p, float(C[m, n, p]))
                for m in range(ir1.dim) for n in range(ir2.dim)
                for p in range(ir3.dim) if abs(C[m, n, p]) > 1e-12
            )
            res.append((n_i, nz))
        return res

    def apply(self, x: Tensor, y: Tensor, w: Tensor) -> Tensor:
        """x: (..., dim1) ir_mul, y: (..., dim2) SH (mul 1),
        w: (..., weight_numel). CG contraction as a static sum of
        scalar-coefficient products over (..., mul) slices."""
        s1 = self.irreps_in1.slices()
        s2 = self.irreps_in2.slices()
        w_off = 0
        blocks: List[Optional[List[Tensor]]] = [None] * len(self.irreps_out)
        for (n_i, nz), (i1, i2, k) in zip(self.cg_nonzeros(),
                                          self.instructions):
            mul1, _ = self.irreps_in1[i1]
            _, ir3 = self.irreps_out[k]
            o1, o2 = s1[i1].start, s2[i2].start
            wn = w[..., w_off:w_off + mul1]
            w_off += mul1
            prod_cache = {}
            acc: List[Optional[Tensor]] = [None] * ir3.dim
            for (m, n, p, c) in nz:
                if (m, n) not in prod_cache:
                    xm = x[..., o1 + m * mul1: o1 + (m + 1) * mul1]
                    prod_cache[(m, n)] = xm * y[..., o2 + n: o2 + n + 1]
                t = prod_cache[(m, n)] * c
                acc[p] = t if acc[p] is None else acc[p] + t
            outp = [(a if a is not None
                     else x.new_zeros(x.shape[:-1] + (mul1,))) * wn
                    for a in acc]
            blocks[k] = (outp if blocks[k] is None
                         else [b + o for b, o in zip(blocks[k], outp)])
        outs = []
        for blk in blocks:
            assert blk is not None
            outs.extend(blk)
        return torch.cat(outs, dim=-1)


@dataclass(frozen=True)
class FullyConnectedTPSpec:
    """e3nn FullyConnectedTensorProduct: 'uvw' paths, internal weights
    (self-connection intro of the 'nequip' type)."""
    irreps_in1: Irreps
    irreps_in2: Irreps
    irreps_out: Irreps
    instructions: Tuple[Tuple[int, int, int], ...] = field(default=None)  # type: ignore

    def __post_init__(self):
        in1 = Irreps(self.irreps_in1).simplify()
        in2 = Irreps(self.irreps_in2).simplify()
        out = Irreps(self.irreps_out).simplify()
        instrs = []
        for i1, (_, ir1) in enumerate(in1):
            for i2, (_, ir2) in enumerate(in2):
                for k, (_, ir3) in enumerate(out):
                    if ir3 in ir1 * ir2:
                        instrs.append((i1, i2, k))
        object.__setattr__(self, 'irreps_in1', in1)
        object.__setattr__(self, 'irreps_in2', in2)
        object.__setattr__(self, 'irreps_out', out)
        object.__setattr__(self, 'instructions', tuple(instrs))

    def alphas(self) -> List[float]:
        fan = {}
        for (i1, i2, k) in self.instructions:
            fan[k] = fan.get(k, 0) + (
                self.irreps_in1[i1].mul * self.irreps_in2[i2].mul)
        return [math.sqrt((2 * self.irreps_out[k].ir.l + 1) / fan[k])
                for (i1, i2, k) in self.instructions]

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {
            f'w{n}': (self.irreps_in1[i1].mul, self.irreps_in2[i2].mul,
                      self.irreps_out[k].mul)
            for n, (i1, i2, k) in enumerate(self.instructions)
        }

    def apply(self, params: Params, x: Tensor, y: Tensor) -> Tensor:
        s1 = self.irreps_in1.slices()
        s2 = self.irreps_in2.slices()
        lead = x.shape[:-1]
        blocks: List[Optional[List[Tensor]]] = [None] * len(self.irreps_out)
        for n, ((i1, i2, k), a) in enumerate(
                zip(self.instructions, self.alphas())):
            m1, ir1 = self.irreps_in1[i1]
            m2, ir2 = self.irreps_in2[i2]
            m3, ir3 = self.irreps_out[k]
            C = wigner_3j(ir1.l, ir2.l, ir3.l) * a
            w = params[f'w{n}'].to(x.dtype)
            o1, o2 = s1[i1].start, s2[i2].start
            acc: List[Optional[Tensor]] = [None] * ir3.dim
            for m in range(ir1.dim):
                xm = x[..., o1 + m * m1: o1 + (m + 1) * m1]
                for n2 in range(ir2.dim):
                    cvec = C[m, n2]
                    if not np.any(np.abs(cvec) > 1e-12):
                        continue
                    yn = y[..., o2 + n2 * m2: o2 + (n2 + 1) * m2]
                    t = torch.einsum('...u,...v,uvw->...w', xm, yn, w)
                    for p in range(ir3.dim):
                        c = float(cvec[p])
                        if abs(c) > 1e-12:
                            tc = t * c
                            acc[p] = tc if acc[p] is None else acc[p] + tc
            outp = [a_ if a_ is not None else x.new_zeros(lead + (m3,))
                    for a_ in acc]
            blocks[k] = (outp if blocks[k] is None
                         else [b + o for b, o in zip(blocks[k], outp)])
        outs = []
        for k, (mul, ir) in enumerate(self.irreps_out):
            blk = blocks[k] or [x.new_zeros(lead + (mul,))
                                for _ in range(ir.dim)]
            outs.extend(blk)
        return torch.cat(outs, dim=-1)


@dataclass(frozen=True)
class GateSpec:
    """Gate over irreps_x: scalars activated, l>0 gated by extra scalars.

    irreps_in  = sort-simplify(scalars + gates) + gated   (e3nn _Sortcut)
    irreps_out = scalars + gated
    """
    irreps_x: Irreps
    act_scalar: Any
    act_gate: Any
    irreps_in: Irreps = field(default=None)  # type: ignore
    scalar_slices: Tuple[Tuple[int, int], ...] = field(default=None)  # type: ignore
    gate_slices: Tuple[Tuple[int, int], ...] = field(default=None)  # type: ignore
    gated_offset: int = field(default=None)  # type: ignore
    scalars: Irreps = field(default=None)  # type: ignore
    gates: Irreps = field(default=None)  # type: ignore
    gated: Irreps = field(default=None)  # type: ignore

    def __post_init__(self):
        for f_name in ('act_scalar', 'act_gate'):
            v = getattr(self, f_name)
            if isinstance(v, dict):
                object.__setattr__(self, f_name, tuple(sorted(v.items())))
        irreps_x = Irreps(self.irreps_x)
        scalars = Irreps([mi for mi in irreps_x if mi.ir.l == 0])
        gated = Irreps([mi for mi in irreps_x if mi.ir.l > 0])
        gates_p = 1 if Irrep(0, 1) in scalars else -1
        gates = Irreps([(mul, Irrep(0, gates_p)) for mul, _ in gated])
        sc = scalars.simplify()
        gt = gates.simplify()
        cat = sc + gt
        srt, p, _ = cat.sort()
        head = srt.simplify()
        offs, o = [], 0
        for mi in srt:
            offs.append(o)
            o += mi.dim
        entry_slice = {e: (offs[p[e]], cat[e].dim) for e in range(len(cat))}
        object.__setattr__(self, 'irreps_x', irreps_x)
        object.__setattr__(self, 'irreps_in', head + gated)
        object.__setattr__(self, 'scalar_slices',
                           tuple(entry_slice[e] for e in range(len(sc))))
        object.__setattr__(self, 'gate_slices', tuple(
            entry_slice[e] for e in range(len(sc), len(sc) + len(gt))))
        object.__setattr__(self, 'gated_offset', head.dim)
        object.__setattr__(self, 'scalars', sc)
        object.__setattr__(self, 'gates', gt)
        object.__setattr__(self, 'gated', gated)

    @property
    def irreps_out(self) -> Irreps:
        return self.scalars + self.gated

    def apply(self, x: Tensor) -> Tensor:
        act_scalar = dict(self.act_scalar)
        act_gate = dict(self.act_gate)
        outs = []
        for (off, ln), (_, ir) in zip(self.scalar_slices, self.scalars):
            outs.append(normalized_activation(act_scalar[ir.p])(
                x[..., off:off + ln]))
        gate_vals = [
            normalized_activation(act_gate[ir.p])(x[..., off:off + ln])
            for (off, ln), (_, ir) in zip(self.gate_slices, self.gates)
        ]
        if gate_vals:
            gates = torch.cat(gate_vals, dim=-1)
            o = self.gated_offset
            g_off = 0
            for mul, ir in self.gated:
                blk = x[..., o:o + mul * ir.dim]
                blk = blk.reshape(blk.shape[:-1] + (ir.dim, mul))
                blk = blk * gates[..., g_off:g_off + mul][..., None, :]
                outs.append(blk.reshape(blk.shape[:-2] + (mul * ir.dim,)))
                o += mul * ir.dim
                g_off += mul
        return torch.cat(outs, dim=-1)


@dataclass(frozen=True)
class FullyConnectedNetSpec:
    """e3nn nn.FullyConnectedNet(hs, act): x -> act(x @ W / sqrt(h_in))
    ..., no biases, last layer linear. f(0) == 0 for silu/tanh/ssp, so a
    zero input row (padded edge) gives exactly zero weights."""
    hs: Tuple[int, ...]
    act: str

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        return {f'w{i}': (self.hs[i], self.hs[i + 1])
                for i in range(len(self.hs) - 1)}

    def apply(self, params: Params, x: Tensor) -> Tensor:
        act = normalized_activation(self.act)
        n = len(self.hs) - 1
        for i in range(n):
            w = params[f'w{i}'] / math.sqrt(self.hs[i])
            x = x @ w.to(x.dtype)
            if i < n - 1:
                x = act(x)
        return x
