"""Per-piece cost of the fused conv forward kernel on the card.

    python -m sevennet_exp_tpu_torch.tools.bench_pieces [E] [block]

Counterpart of ``tools/bench_pieces.py``. Runs stripped variants of the
production forward kernels on the 7net-0 mid layer
(``sevennet_0_config(species=['Na', 'Cl'])``, third convolution), each
piece replaced by a near-free stand-in, and reports the time each piece
costs inside the real kernel. The variants are instances of
``csrc/fused_conv_geom.cu``'s forward template built as the library
``bench_pieces`` (``-DFUSED_CONV_PIECES=1``, a stub mask in the template's
``MODE``, ``MODES`` below): ``full`` is kernel 1 itself (the dense forward,
its SASS), ``-agg`` the edge-row kernel 1 itself (the edge forward that the
calculator runs), and the other four the dense forward with one piece
stubbed, each launched as its production kernel is (tile, row groups,
shared bytes and persistent grid of ``ops/fused_conv_geom.py::shape``):

  full   the production kernel (MLP + CG + w + agg + si2)
  -mlp   radial weights = first emb column broadcast (times ms): no hidden
         layers, no w pass
  -cg    each component's CG sum = the instruction's x entry m = 0
  -w     no radial-weight multiply: the w pass kept, the CG adds its sums
         with weight 1 on every row whose weight is not 0 (ms != 0, unless
         the MLP returns an exact 0 there)
  -agg   no sum over the atom's D rows: si2 on every row, (E, 576) edge
         rows out (the edge-row form of kernel 1)
  -si2   no si2: each group's aggregate written straight into its output
         columns, truncated or zero-padded to the group's width

E rows (default 32768) of D = 32 per atom, random weights, ``ms = 1``;
prints each variant's ms and ns per row (CUDA events), then after each
stripped variant its piece cost, full minus variant, in ns per row; then
(``production_ms``) the production kernel each variant is or stubs, timed
beside it on the same inputs.

Where it differs from the JAX tool: the inputs come from a seeded
``torch.Generator`` on the card (the JAX PRNG stream cannot be reproduced);
``block`` (default 256) only has to divide E as the JAX grid's block did,
since the kernels walk the atoms with persistent blocks; ``-transpose``,
named in the JAX docstring, is never run there and has no counterpart for
a kernel that reads rows as they lie; and the JAX ``-agg`` stores (block, 576) into a
(block / 32, 576) output block, which cannot hold it, where this ``-agg``
writes the edge rows its docstring describes. The aggregate keeps the
XLA path's layout as every kernel of the port does (ROADMAP C), so ``-si2``
copies a group's entry as si2 reads it, (dim3, K) row-major.

Needs a card: the kernels have no CPU mode, so without one the tool exits
nonzero. On CPU tensors the wrappers below run the plain versions (tests).
"""

from __future__ import annotations

import ctypes
import functools
import re
import sys
from typing import Dict, Tuple

import torch

from ..model.build import build_e3_equivariant_model
from ..model.layers import IrrepsConvolution
from ..ops import cuda_build
from ..ops.fused_conv import (_DIM_ARGS, _TABLE_ARGS, FusedConv, conv_bytes,
                              conv_cost)
from ..ops.fused_conv_geom import Resources
from ..presets import sevennet_0_config
from .timing import card, cuda_ms, require_card

Tensor = torch.Tensor

D = 32
VARIANTS = ('full', '-mlp', '-cg', '-w', '-agg', '-si2')
COUNTER = {'full': 'bench_pieces_full', '-mlp': 'bench_pieces_nomlp',
           '-cg': 'bench_pieces_nocg', '-w': 'bench_pieces_now',
           '-agg': 'bench_pieces_noagg', '-si2': 'bench_pieces_nosi2'}
# the forward template's MODE of each variant (csrc/fused_conv_geom.cu:
# K_DENSE 0, K_EDGE 2, the stub mask S_MLP 16, S_CG 32, S_W 64, S_SI2 128)
MODES = {'full': 0, '-mlp': 16, '-cg': 32, '-w': 64, '-agg': 2, '-si2': 128}
_KERNEL = re.compile(r'fused_conv_geom_fwd_kernelILi(\d+)EE')


def variant_of(kernel: str):
    """The variant whose instance a (mangled) kernel name of the
    ``bench_pieces`` build is, or None."""
    m = _KERNEL.search(kernel)
    by_mode = {v: k for k, v in MODES.items()}
    return by_mode.get(int(m.group(1))) if m else None


def mid_layer_conv(agg_d: int = D) -> FusedConv:
    """The 7net-0 mid layer (third convolution) as a FusedConv."""
    model = build_e3_equivariant_model(sevennet_0_config(species=['Na', 'Cl']))
    conv = [lay for lay in model.layers.values()
            if isinstance(lay, IrrepsConvolution)][2]
    return FusedConv(conv.tp, conv.weight_nn, conv.si2, agg_d)


def make_inputs(conv: FusedConv, rows: int, device, seed: int = 0):
    """(xg, sh, emb, ms, mlp_ws, si2_ws): standard normal from one seeded
    generator on ``device``, ms = 1."""
    device = torch.device(device)
    gen = torch.Generator(device).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    xg, sh, emb = normal(rows, conv.d1), normal(rows, conv.f), \
        normal(rows, conv.nb)
    ms = torch.ones(rows, 1, device=device)
    hs = conv.mlp.hs
    mlp_ws = tuple(normal(hs[i], hs[i + 1]) for i in range(3))
    si2_ws = tuple(normal(mi, mo) for (_, _, mi, mo, _) in conv.si2.paths)
    return xg, sh, emb, ms, mlp_ws, si2_ws


# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------

def _mlp_w(conv, emb, ms, mlp_ws):
    return conv.mlp.apply({f'w{i}': v for i, v in enumerate(mlp_ws)},
                          emb) * ms


def _si2(conv, agg, si2_ws):
    return conv.si2.apply({f'w{n}': v for n, v in enumerate(si2_ws)}, agg,
                          skip_bias=True)


def _sum_rows(conv, message):
    return message.reshape(message.shape[0] // conv.group, conv.group,
                           -1).sum(1)


def _cg_stub_message(conv, xg, w):
    """The message with every CG sum replaced by the instruction's x entry
    m = 0: block k of the ir_mul message, (dim3, mul), is that entry times
    the instruction's weights in every component."""
    blocks = [None] * len(conv.tp.irreps_out)
    for p in conv.plan:
        x0 = xg[:, p['x_off']:p['x_off'] + p['mul']]
        wn = w[:, p['w_off']:p['w_off'] + p['mul']]
        blocks[p['k']] = (x0 * wn).repeat(1, p['dim3'])
    return torch.cat(blocks, dim=1)


def _si2_stub(conv, agg):
    """Each si2 group's aggregate entry, read as si2 reads it ((dim3, K)
    row-major), into the group's output columns (dim3, mo): the first
    min(K, mo) columns, zeros after them and in unfed output columns."""
    n = agg.shape[0]
    out = agg.new_zeros(n, conv.d_out)
    in_slices = conv.si2.irreps_in.slices()
    for g in conv.groups:
        sl = in_slices[conv.si2.paths[g['path']][0]]
        K, mo, d3 = g['K'], g['mo'], g['dim3']
        a = agg[:, sl].reshape(n, d3, K)
        o = out[:, g['out_off']:g['out_off'] + d3 * mo].view(n, d3, mo)
        c = min(K, mo)
        o[:, :, :c] = a[:, :, :c]
    return out


def plain_variant(conv: FusedConv, variant: str, xg, sh, emb, ms, mlp_ws,
                  si2_ws) -> Tensor:
    """The function each kernel variant computes, in plain PyTorch."""
    if variant == 'full':
        return conv.plain_forward(xg, sh, emb, ms, mlp_ws, si2_ws)
    wn = conv.w_numel
    if variant == '-mlp':
        w = emb[:, :1].expand(-1, wn) * ms
    elif variant == '-w':
        w = (ms != 0).to(xg.dtype).expand(-1, wn)
    else:
        w = _mlp_w(conv, emb, ms, mlp_ws)
    if variant == '-cg':
        message = _cg_stub_message(conv, xg, w)
    else:
        message = conv.tp.apply(xg, sh, w)
    if variant == '-agg':
        return _si2(conv, message, si2_ws)
    agg = _sum_rows(conv, message)
    if variant == '-si2':
        return _si2_stub(conv, agg)
    return _si2(conv, agg, si2_ws)


# ---------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lib():
    """csrc/fused_conv_geom.cu built as ``bench_pieces``."""
    lib = cuda_build.load('bench_pieces')
    P = ctypes.c_void_p
    lib.bench_pieces_fwd.argtypes = ([ctypes.c_int] + [P] * 8 + _TABLE_ARGS
                                     + _DIM_ARGS + [P, P])
    lib.bench_pieces_fwd.restype = ctypes.c_int
    lib.bench_pieces_resources.argtypes = ([ctypes.c_int] + _TABLE_ARGS
                                           + _DIM_ARGS + [P])
    lib.bench_pieces_resources.restype = ctypes.c_int
    return lib


def kernel_variant(conv: FusedConv, variant: str, xg, sh, emb, ms, mlp_ws,
                   si2_ws) -> Tensor:
    """Launch the variant (CUDA tensors only) with the tables, weights and
    plan kernel 1 takes (the C entry hands ``-agg`` the plan's rows as the
    edge list, as ``fused_conv_edge_fwd`` takes them), on the same
    inputs."""
    conv._check_inputs(xg, sh, emb, ms)
    t = conv.kernel_tables(xg.device)
    w0, w1, _, w2, _, si2, _ = conv._pack(mlp_ws, si2_ws)
    rows = xg.shape[0]
    n_out = rows if variant == '-agg' else rows // conv.group
    out = torch.empty((n_out, conv.d_out), dtype=xg.dtype, device=xg.device)
    P = conv._ptr
    err = _lib().bench_pieces_fwd(
        VARIANTS.index(variant), P(xg), P(sh), P(emb), P(ms), P(w0), P(w1),
        P(w2), P(si2), *conv._table_ptrs(t), *conv._dims(t, rows), P(out),
        ctypes.c_void_p(torch.cuda.current_stream(xg.device).cuda_stream))
    cuda_build.check(err, COUNTER[variant])
    cuda_build.launch_counts[COUNTER[variant]] += 1
    return out


def resources(conv: FusedConv, variant: str, rows: int,
              device) -> Resources:
    """The variant's compiled kernel as launched on ``rows`` rows of the
    current card: registers, local bytes, blocks an SM, shared bytes."""
    t = conv.kernel_tables(torch.device(device))
    out = (ctypes.c_int * 4)()
    err = _lib().bench_pieces_resources(
        VARIANTS.index(variant), *conv._table_ptrs(t),
        *conv._dims(t, rows), out)
    cuda_build.check(err, 'bench_pieces_resources')
    return Resources(*out)


def variant_forward(conv: FusedConv, variant: str, *args) -> Tensor:
    """The kernel for CUDA tensors, the plain version for CPU ones."""
    dev = args[0].device.type
    if dev == 'cuda':
        return kernel_variant(conv, variant, *args)
    if dev == 'cpu':
        return plain_variant(conv, variant, *args)
    raise ValueError(f'bench_pieces: no kernel for device {dev}')


def variant_cost(conv: FusedConv, ms: Tensor, variant: str
                 ) -> Tuple[float, float]:
    """(flops, bytes) of one launch of the variant: kernel 1's forward count
    (fused_conv.conv_cost / conv_bytes) less the stubbed piece, for -agg
    with si2 and the output on every row."""
    flops, _, real = conv_cost(conv, ms)
    nbytes = conv_bytes(conv, ms)[0]
    rows = ms.shape[0]
    n_out = rows // conv.group
    H = conv.mlp.hs[1]
    active = [p for g in conv.groups for p, _ in g['ks']]
    n_active = sum(p['mul'] for p in active)
    si2 = sum(g['K'] * g['mo'] * g['dim3'] for g in conv.groups)
    if variant == '-mlp':
        flops -= 2.0 * real * (conv.nb * H + H * H + H * n_active)
        nbytes -= 4.0 * (conv.nb * H + H * H + H * n_active)
    elif variant == '-cg':
        flops -= 3.0 * real * sum(p['mul'] * len(p['nz']) for p in active)
    elif variant == '-w':
        flops -= real * sum(p['mul'] * p['dim3'] for p in active)
    elif variant == '-agg':
        flops += 2.0 * (rows - n_out) * si2
        nbytes += 4.0 * (rows - n_out) * conv.d_out
    elif variant == '-si2':
        flops -= 2.0 * n_out * si2
        nbytes -= 4.0 * sum(g['K'] * g['mo'] for g in conv.groups)
    return flops, nbytes


def run(E: int = 32768, block: int = 256, reps: int = 20) -> Dict:
    """Every variant once (its output kept), then timed; prints as the JAX
    tool does. Returns {'conv', 'inputs', 'out': {variant: tensor},
    'ms': {variant: ms}, 'piece_ns': {variant: ns per row}}."""
    if E % block or block % D:
        raise ValueError(f'E = {E} must be a multiple of block = {block}, '
                         f'and block of D = {D}')
    conv = mid_layer_conv()
    inputs = make_inputs(conv, E, 'cuda')
    print(f'mid layer: d1={conv.d1} f={conv.f} nb={conv.nb} '
          f'wn={conv.w_numel} d_out={conv.d_out} E={E} D={D} block={block}',
          flush=True)
    res = {'conv': conv, 'inputs': inputs, 'out': {}, 'ms': {},
           'piece_ns': {}}
    for variant in VARIANTS:
        res['out'][variant] = variant_forward(conv, variant, *inputs)
        ms = cuda_ms(lambda: variant_forward(conv, variant, *inputs),
                     reps=reps)
        res['ms'][variant] = ms
        print(f'{variant:12s}: {ms:8.3f} ms  {ms / E * 1e6:6.2f} ns/row   '
              f'(CUDA events)', flush=True)
        if variant != 'full':
            cost = (res['ms']['full'] - ms) / E * 1e6
            res['piece_ns'][variant] = cost
            print(f'{"":12s}  -> piece cost {cost:6.2f} ns/row', flush=True)
    return res


def edge_conv(conv: FusedConv) -> FusedConv:
    """The same layer on the edge list (``agg_d = 0``): the conv whose
    kernel 1 is the edge-row form that ``-agg`` is."""
    return FusedConv(conv.tp, conv.mlp, conv.si2, 0)


def production_ms(res: Dict, reps: int = 20) -> Dict:
    """The production kernel each variant of ``run``'s result is or stubs,
    timed beside it on the same inputs in turns (production, variant,
    variant, production; the means of the two): kernel 1
    (``conv.kernel_forward``) for the dense variants, the edge-row kernel 1
    (``edge_conv``) for ``-agg``. Prints both and their ratio; returns
    {variant: {'production', 'production_ms', 'turns_ms'}}."""
    conv, ins = res['conv'], res['inputs']
    edge = edge_conv(conv)
    prod = {'kernel 1': lambda: conv.kernel_forward(*ins),
            'edge kernel 1': lambda: edge.kernel_forward(*ins)}
    out = {}
    for v in VARIANTS:
        name = 'edge kernel 1' if v == '-agg' else 'kernel 1'
        times = [cuda_ms(fn, reps=reps) for fn in (
            prod[name], lambda: variant_forward(conv, v, *ins),
            lambda: variant_forward(conv, v, *ins), prod[name])]
        p_ms, v_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        out[v] = {'production': name, 'production_ms': p_ms,
                  'turns_ms': v_ms}
        print(f'{v:12s}: {v_ms:8.3f} ms beside {name} {p_ms:8.3f} ms '
              f'(x{v_ms / p_ms:.3f}; in turns, CUDA events)', flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not require_card('bench_pieces'):
        return 2
    E = int(argv[0]) if len(argv) > 0 else 32768
    block = int(argv[1]) if len(argv) > 1 else 256
    torch.backends.cuda.matmul.allow_tf32 = False
    print(card(), flush=True)
    production_ms(run(E, block))
    return 0


if __name__ == '__main__':
    sys.exit(main())
