"""Same-call A/B of the redesigned kernels against an earlier build: with
``--terms`` the ``terms`` backward (``fused_conv_terms_bwd``, both forms),
with ``--extw`` the external-weight backward (``fused_conv_extw_bwd``),
with ``--terms-fwd`` / ``--extw-fwd`` the two forwards; with ``--dot-bf16``
/ ``--outer`` / ``--st`` / ``--cg-c`` the micro-benchmark kernels
``dot_bf16`` / ``cgmxu_outer`` / ``cgmxu_st`` / ``cg_c``; with ``--tp-bwd``
the bare tensor product's backward (``fused_tp_bwd``), with
``--layout-transpose`` ``bench_layout``'s ``layout_transpose``, with
``--tile-c`` / ``--tile-b`` ``bench_tile``'s c and b.

    python -m sevennet_exp_tpu_torch.tools.bwd_ab OTHER_CSRC [STEPS] [OUT.json] --terms | --extw | --terms-fwd | --extw-fwd | --dot-bf16 | --outer | --st | --cg-c | --tp-bwd | --layout-transpose | --tile-c | --tile-b

OTHER_CSRC is an earlier tree's ``csrc`` directory unpacked with ``git
archive`` (its ``fused_conv_terms.cu``, or its ``fused_conv.cu`` with the
headers beside it, where these kernels had the earlier C entries:
``fused_conv_terms_bwd`` with w2 and w2^T, ``fused_conv_extw_bwd`` with the
dead weight columns, ``fused_conv_terms_fwd`` with all of w2 and no plan,
``fused_conv_extw_fwd`` with no tile). It is compiled with the port's nvcc
flags and bound by ``other_launcher``; then, on one card, the two builds
run in turns (other, this, this, other); a forward kind times the forward
where the list below says backward, on the same inputs and paths:

  - ``--terms``: the backward on the 1k grid's shape (1,000 atoms x 32 rows,
    6 pad rows an atom, sh and emb of random edge vectors, seed 0) and on
    the 1k calculator's 31,232 rows (the last 5,232 pads), the checkpoint's
    five layers each; the 1k NPT engine's force call (``_efs_fn``, the terms
    kernels' launches timed by CUDA events, and the host clock), the 1k
    calculator call under ``cg_mode='terms'``, and 1k NPT (1 GPa,
    ``pdamp_fs = 0.02``) in ms/step over STEPS (default 100) steps;
  - ``--extw``: the backward on the 1k ``half_mlp`` grid's shape (the
    weights MLP(emb) * ms of the same rows), the five layers; the 1k
    ``half_mlp`` force call and 1k ``half_mlp`` NVT in ms/step.

  - ``--dot-bf16``: OTHER_CSRC's ``bench_dot.cu``, whose ``dot_bf16`` took
    no plan, on the ten ``bench_dot`` shapes; ``--outer``: its
    ``bench_cgmxu.cu`` (the same ``cgmxu_outer`` entry) at i1 = 1 and 2,
    E = 32,768; ``--st``: its ``cgmxu_st`` (the same arguments; an earlier
    tree's kernel reads the instruction records from the card, this one's
    from the host) at i1 = 1 and 2, E = 32,768; ``--cg-c``: its
    ``bench_cg.cu`` (the same ``cg_c`` entry) at E = 32,768. Each build's
    output is first held to the tool's plain version (bf16: 1e-5 K
    max|plain|, phase 15's limit; outer, st and c: 1e-4 max|plain|), then
    both are timed in turns (CUDA events, 20 reps).
  - ``--tp-bwd``: OTHER_CSRC's ``fused_tp.cu``, whose ``fused_tp_bwd`` took
    the forward's instruction records and term pool (a tree before the
    backward's redesign), on chip_smoke phase 13's inputs: the checkpoint's
    five specs at the 1k grid's 32,000 rows (xg and sh of ``dense_inputs``,
    w = MLP(emb) ms, a seeded normal cotangent); (dxg, dsh, dw) each held
    to ``plain_backward`` within 1e-4 of its max|plain| (phase 13's limit).
    ``--layout-transpose``: its ``bench_layout.cu`` (the same
    ``layout_transpose`` entry) on the tool's (32768, 512) inputs, held to
    the plain version within 1e-4 max|plain|, and the two builds'
    ``layout_rowmajor`` (an unchanged kernel) timed in the same turns.
  - ``--tile-c`` / ``--tile-b``: its ``bench_tile.cu`` (the same
    ``tile_c`` / ``tile_dab`` entries) on the tool's E = 32,768 inputs,
    each launch on the next of the tool's rotating copies (the first on
    the copy the plain version is held to, within 1e-4 max|plain|); the
    two builds' ``tile_d`` (an unchanged kernel) timed in the same turns.
    The micro kinds also print each case's time ratio, other / this.

After the turns of a conv kind, each layer's outputs of the two builds are
compared (relative to max|other|). Prints one line per turn and the means
of each side; writes them to OUT.json when given. Needs a card (exits 2
without one).
"""

from __future__ import annotations

import ctypes
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import fused_conv as fc
from ..ops import fused_conv_geom as fcg
from ..ops import fused_conv_terms as fct
from ..ops import fused_tp as ftp
from . import bench_cg, bench_cgmxu, bench_dot, bench_layout, bench_tile
from .geom_ab import CHECKPOINT, D, dense_inputs, edge_inputs
from .timing import card, cuda_ms, require_card

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
_F = ctypes.c_float
NPT_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='npt',
              pressure_gpa=1.0, pdamp_fs=0.02, rebuild_every=20, seed=0)
NVT_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
              rebuild_every=20, seed=0)


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def build(src: str, out: str, defines=()) -> ctypes.CDLL:
    """SRC compiled with the port's nvcc flags (and DEFINES) into OUT."""
    subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS,
                    *defines, '-o', out, src], check=True,
                   capture_output=True, text=True)
    return ctypes.CDLL(out)


class LibPool:
    """The constant term pool of one library of ``fused_conv_terms.cu`` (or
    of ``fused_tp.cu``: PREFIX ``fused_tp``): each plan's terms uploaded
    once, at the offset it keeps."""

    def __init__(self, lib: ctypes.CDLL, prefix: str = 'fused_conv_terms'):
        self.lib, self.used, self.placed = lib, 0, {}
        self.upload = getattr(lib, f'{prefix}_upload')
        self.upload.argtypes = [_I, _I, _P, _P]
        self.upload.restype = _I

    def place(self, plan) -> int:
        key = (plan.idx.tobytes(), plan.coef.tobytes())
        if key not in self.placed:
            idx = np.ascontiguousarray(plan.idx, np.int32)
            coef = np.ascontiguousarray(plan.coef, np.float32)
            cuda_build.check(self.upload(
                self.used, idx.size, idx.ctypes.data, coef.ctypes.data),
                'term pool upload')
            self.placed[key] = self.used
            self.used += idx.size
        return self.placed[key]


# the earlier trees' TERMS_ARGS: seven tables (the instruction records with
# their term offsets, slices, live columns, si2 paths, alphas, column and
# message paths), then the counts and shapes with n_ins, wn and d_msg
_PARENT_TERMS_ARGS = [_P] * 7 + [_I] * 4 + [_L] + [_I] * 8 + [_F] * 4


def _terms_tables(tk, pool: LibPool, dev, parent: bool):
    """(base, tables): the plan's terms placed in POOL at base, and the
    device tables of the port's TERMS_ARGS or (PARENT) the earlier ones."""
    p = tk.plan
    base = pool.place(p)

    def dt(a):
        a = a.reshape(-1)
        return torch.tensor(a if a.size else np.zeros(1, a.dtype), device=dev)

    if not parent:
        return base, [dt(p.slices), dt(p.path_alpha)]
    ins = p.ins.copy()
    ins[:, 6:10] += base
    return base, [dt(a) for a in (ins, p.slices, p.live_cols, p.paths,
                                  p.path_alpha, p.col_path, p.msg_path)]


def _terms_args(tk, tables, rows, agg_d, parent: bool):
    """The TERMS_ARGS of a launch, tables first."""
    sc = tk.scalars(rows, agg_d)
    if parent:
        n_slices, n_live, n_paths, *mid, d_out = sc[:9]
        sc = [tk.plan.ins.shape[0], n_slices, n_live, n_paths, *mid, tk.wn,
              tk.plan.d_msg, d_out, *sc[9:]]
    return [_ptr(t) for t in tables] + sc


def terms_launcher(lib: ctypes.CDLL, parent: bool):
    """A function with ``TermsKernels.backward``'s signature that launches
    LIB's ``fused_conv_terms_bwd``: the port's ABI, or with PARENT the
    earlier one (w2 and w2^T, no backward plan)."""
    pool = LibPool(lib)
    fn = lib.fused_conv_terms_bwd
    fn.argtypes = ([_P] * 11
                   + (_PARENT_TERMS_ARGS if parent else fct._TERMS_ARGS)
                   + ([] if parent else fct._BWD_ARGS) + [_P] * 4)
    fn.restype = _I
    cache = {}

    def backward(tk, agg_d, g, xg, sh, emb, ms, w0, w1, w1t, w2, si2t):
        key = (id(tk), agg_d, xg.device)
        if key not in cache:
            base, tables = _terms_tables(tk, pool, xg.device, parent)
            extra = []
            if not parent:
                b = tk.bwd_plan(agg_d)
                bins = b.bins.copy()
                bins[:, 7:9] += base
                extra = [torch.tensor(a.reshape(-1) if a.size else
                                      np.zeros(1, np.int32), device=xg.device)
                         for a in (bins, b.xcls, b.users, b.gpaths)]
            cache[key] = (tables, extra)
        tables, extra = cache[key]
        dxg, dsh, demb = (torch.empty_like(t) for t in (xg, sh, emb))
        if parent:
            w2b, w2c = w2, w2.t().contiguous()
        else:
            w2b, w2c = tk._live_w2(w2)
        tail = []
        if not parent:
            b = tk.bwd_plan(agg_d)
            tail = [_ptr(t) for t in extra] + [
                b.bins.shape[0], b.xcls.shape[0], b.users.size, b.n_msg,
                b.n_q, b.nls, b.n_items, b.T, b.R, b.words]
        err = fn(_ptr(g), _ptr(xg), _ptr(sh), _ptr(emb), _ptr(ms), _ptr(w0),
                 _ptr(w1), _ptr(w1t), _ptr(w2b), _ptr(w2c), _ptr(si2t),
                 *_terms_args(tk, tables, xg.shape[0], agg_d, parent), *tail,
                 _ptr(dxg), _ptr(dsh), _ptr(demb), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_bwd')
        fc.launch_counts['fused_conv_terms_bwd'] += 1
        return dxg, dsh, demb
    return backward


def terms_fwd_launcher(lib: ctypes.CDLL, parent: bool):
    """A function with ``TermsKernels.forward``'s signature that launches
    LIB's ``fused_conv_terms_fwd``: the port's ABI, or with PARENT the
    earlier one (all of w2, no forward plan)."""
    pool = LibPool(lib)
    fn = lib.fused_conv_terms_fwd
    fn.argtypes = ([_P] * 8
                   + (_PARENT_TERMS_ARGS if parent else fct._TERMS_ARGS)
                   + ([] if parent else fct._FWD_ARGS) + [_P, _P])
    fn.restype = _I
    cache = {}

    def forward(tk, agg_d, xg, sh, emb, ms, w0, w1, w2, si2):
        key = (id(tk), agg_d, xg.device)
        if key not in cache:
            base, tables = _terms_tables(tk, pool, xg.device, parent)
            extra = []
            if not parent:
                f = tk.fwd_plan(agg_d)
                folds = f.folds.copy()
                folds[:, 4:6] += base
                extra = [torch.tensor(a.reshape(-1) if a.size else
                                      np.zeros(1, np.int32), device=xg.device)
                         for a in (f.fins, folds, f.fpaths, f.unfed)]
            cache[key] = (tables, extra)
        tables, extra = cache[key]
        rows = xg.shape[0]
        out = torch.empty((rows // max(agg_d, 1), tk.plan.d_out),
                          dtype=xg.dtype, device=xg.device)
        w2b = w2 if parent else tk._live_w2(w2)[0]
        tail = [] if parent else tk.fwd_args(agg_d, extra)
        err = fn(_ptr(xg), _ptr(sh), _ptr(emb), _ptr(ms), _ptr(w0), _ptr(w1),
                 _ptr(w2b), _ptr(si2),
                 *_terms_args(tk, tables, rows, agg_d, parent), *tail,
                 _ptr(out), _stream(xg))
        cuda_build.check(err, 'fused_conv_terms_fwd')
        fc.launch_counts['fused_conv_terms_fwd'] += 1
        return out
    return forward


def extw_fwd_launcher(lib: ctypes.CDLL, parent: bool):
    """A function with ``FusedConv.kernel_extw_forward``'s signature that
    launches LIB's ``fused_conv_extw_fwd``: the port's ABI, or with PARENT
    the earlier one (no tile and row groups)."""
    fn = lib.fused_conv_extw_fwd
    fn.argtypes = ([_P] * 4 + fc._TABLE_ARGS + fc._DIM_ARGS
                   + ([] if parent else [_I, _I, _I]) + [_P, _P])
    fn.restype = _I

    def forward(conv, xg, sh, weff, si2_ws):
        t = conv.kernel_tables(xg.device)
        si2, _ = conv._pack((), si2_ws)
        out = torch.empty((xg.shape[0] // conv.group, conv.d_out),
                          dtype=xg.dtype, device=xg.device)
        mid = []
        if not parent:
            dims = fcg.extw_dims(conv)
            T, s = fcg.extw_fwd_shape(dims)
            mid = [T, s, fcg.extw_fwd_words(dims, T, s)]
        err = fn(_ptr(xg), _ptr(sh), _ptr(weff), _ptr(si2),
                 *conv._table_ptrs(t), *conv._dims(t, xg.shape[0]), *mid,
                 _ptr(out), _stream(xg))
        cuda_build.check(err, 'fused_conv_extw_fwd')
        fc.launch_counts['fused_conv_extw_fwd'] += 1
        return out
    return forward


def extw_launcher(lib: ctypes.CDLL, parent: bool):
    """A function with ``FusedConv.kernel_extw_backward``'s signature that
    launches LIB's ``fused_conv_extw_bwd``: the port's ABI, or with PARENT
    the earlier one (the dead weight columns as a table)."""
    fn = lib.fused_conv_extw_bwd
    fn.argtypes = ([_P] * 5 + fc._TABLE_ARGS + fc._DIM_ARGS
                   + [_P if parent else _I, _I] + [_P] * 4)
    fn.restype = _I

    def backward(conv, g, xg, sh, weff, si2_ws):
        g = g.contiguous()
        t = conv.kernel_tables(xg.device)
        _, si2t = conv._pack((), si2_ws)
        dxg, dsh, dweff = (torch.empty_like(a) for a in (xg, sh, weff))
        if parent:
            mid = [_ptr(t.dead_w), t.n_dead]
        else:
            dims = fcg.extw_dims(conv)
            T = fcg.extw_tile(dims)
            mid = [T, fcg.extw_words(dims, T)]
        err = fn(_ptr(g), _ptr(xg), _ptr(sh), _ptr(weff), _ptr(si2t),
                 *conv._table_ptrs(t), *conv._dims(t, xg.shape[0]), *mid,
                 _ptr(dxg), _ptr(dsh), _ptr(dweff), _stream(xg))
        cuda_build.check(err, 'fused_conv_extw_bwd')
        fc.launch_counts['fused_conv_extw_bwd'] += 1
        return dxg, dsh, dweff
    return backward


def tp_launcher(lib: ctypes.CDLL, parent: bool):
    """A function (op, g, xg, sh, w) -> (dxg, dsh, dw) that launches LIB's
    ``fused_tp_bwd``: the port's ABI (``FusedTP.bwd_kernel_tables``), or
    with PARENT the earlier one (the forward's instruction records and
    slices, their terms in LIB's constant pool; this tree's
    ``fused_tp_bwd_table`` keeps it)."""
    fn = lib.fused_tp_bwd
    dims = [_L, _I, _I, _I, _I]
    fn.argtypes = [_P] * 4 + ([_P, _P, _I, _I] if parent else
                              [_P, _P, _I, _I, _I, _I]) + dims + [_P] * 4
    fn.restype = _I
    pool = LibPool(lib, 'fused_tp') if parent else None
    cache = {}

    def backward(op, g, xg, sh, w):
        dev = xg.device
        if parent:
            if (id(op), dev) not in cache:
                ins, slices, idx, coef = ftp.pack_plan(op.plan)
                base = pool.place(SimpleNamespace(idx=idx, coef=coef))
                ins = ins.copy()
                ins[:, 6:10] += base
                cache[id(op), dev] = tuple(
                    torch.tensor(a.reshape(-1), device=dev)
                    for a in (ins, slices))
            ins, slices = cache[id(op), dev]
            tables = [_ptr(ins), _ptr(slices), len(op.plan),
                      slices.numel() // 2]
        else:
            steps, slots, n_steps, nsh, lm, run = op.bwd_kernel_tables(dev)
            tables = [_ptr(steps), _ptr(slots), n_steps, nsh, lm, run]
        dxg, dsh, dw = (torch.empty_like(t) for t in (xg, sh, w))
        cuda_build.check(fn(_ptr(g), _ptr(xg), _ptr(sh), _ptr(w), *tables,
                            xg.shape[0], op.d1, op.f, op.w_numel, op.d3,
                            _ptr(dxg), _ptr(dsh), _ptr(dw), _stream(xg)),
                         'fused_tp_bwd')
        return dxg, dsh, dw
    return backward


def tp_inputs(model, dev, seed: int = 0):
    """{layer: (op, (g, xg, sh, w))}: chip_smoke phase 13's inputs, the
    checkpoint's five specs on the 1k grid's rows (xg, sh of
    ``dense_inputs``, w = MLP(emb) ms) and a seeded normal cotangent."""
    gen = torch.Generator(dev).manual_seed(seed)
    out = {}
    for (layer, _), (conv, _, (xg, sh, w, _)) in layer_inputs(
            model, 'extw', dev).items():
        op = ftp.make_fused_tp(conv.tp)
        g = torch.randn(xg.shape[0], op.d3, device=dev, generator=gen)
        out[layer] = (op, (g, xg, sh, w))
    return out


# the method each kind's launcher takes the place of, and its launcher
SLOTS = {'terms': (fct.TermsKernels, 'backward', terms_launcher),
         'extw': (fc.FusedConv, 'kernel_extw_backward', extw_launcher),
         'terms_fwd': (fct.TermsKernels, 'forward', terms_fwd_launcher),
         'extw_fwd': (fc.FusedConv, 'kernel_extw_forward', extw_fwd_launcher)}
KINDS = tuple(SLOTS)
_PORT = {kind: getattr(owner, attr) for kind, (owner, attr, _) in
         SLOTS.items()}


def launcher(kind: str, lib: ctypes.CDLL, parent: bool):
    """KIND's kernel of LIB, with the port's ABI or (PARENT) the earlier
    one."""
    return SLOTS[kind][2](lib, parent)


def port_launcher(kind: str):
    """The port's own kernel of KIND, unpatched."""
    return _PORT[kind]


def install(kind: str, fn):
    """Make FN the kernel every conv of KIND launches."""
    owner, attr, _ = SLOTS[kind]
    setattr(owner, attr, fn)


def other_launcher(other_csrc: str, kind: str, out_dir: str):
    name = ('fused_conv.cu' if kind.startswith('extw')
            else 'fused_conv_terms.cu')
    lib = build(os.path.join(other_csrc, name),
                os.path.join(out_dir, f'lib_other_{kind}.so'))
    return launcher(kind, lib, True)


def layer_inputs(model, kind: str, dev):
    """{(layer, agg_d): (conv, weights, inputs)} at the 1k shapes: the
    grid (and for terms the calculator's rows); extw: (xg, sh, weff, g)
    with weff = MLP(emb) * ms."""
    out = {}
    for layer in range(5):
        cl = model.layers[f'{layer}_convolution']
        mlp_ws, si2_ws = cl._weights()
        if kind.startswith('terms'):
            for dd in (D, 0):
                conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, dd,
                                    cg_mode='terms')
                ins = (edge_inputs(conv, cl.geom, dev) if dd == 0 else
                       dense_inputs(conv, cl.geom, dev, 1000))
                out[layer, dd] = (conv, (mlp_ws, si2_ws), ins)
        else:
            conv = fc.FusedConv(cl.tp, cl.weight_nn, cl.si2, D, ext_w=True)
            xg, sh, emb, ms, g = dense_inputs(conv, cl.geom, dev, 1000)
            weff = (conv.mlp.apply({f'w{i}': w for i, w in
                                    enumerate(mlp_ws)}, emb) * ms
                    ).contiguous()
            out[layer, D] = (conv, (mlp_ws, si2_ws), (xg, sh, weff, g))
    return out


def call(kind, conv, ws, ins):
    """KIND's kernel on one layer's inputs (through the conv's wrapper)."""
    mlp_ws, si2_ws = ws
    if kind.startswith('terms'):
        xg, sh, emb, ms, g = ins
        if kind == 'terms_fwd':
            return conv.kernel_forward(xg, sh, emb, ms, mlp_ws, si2_ws),
        return conv.kernel_backward(g, xg, sh, emb, ms, mlp_ws, si2_ws)
    xg, sh, weff, g = ins
    if kind == 'extw_fwd':
        return conv.kernel_extw_forward(xg, sh, weff, si2_ws),
    return conv.kernel_extw_backward(g, xg, sh, weff, si2_ws)


def timed_call(fn, names):
    """(kernel ms of the NAMES launches, host-clock ms) of one fn()."""
    pairs = []
    saved = {}
    for owner, attr in names:
        orig = getattr(owner, attr)
        saved[owner, attr] = orig

        def wrapped(*args, _orig=orig):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = _orig(*args)
            b.record()
            pairs.append((a, b))
            return out
        setattr(owner, attr, wrapped)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3
    finally:
        for (owner, attr), orig in saved.items():
            setattr(owner, attr, orig)
    return sum(a.elapsed_time(b) for a, b in pairs), host


def md_ms_per_step(md, steps):
    md.run(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    md.run(steps)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def run(other_csrc: str, kind: str, steps: int = 100):
    from ..calculator import SevenNetCalculator
    from ..checkpoint import SevenNetCheckpoint
    from ..data.graph import build_nacl
    from ..md.engine import MolecularDynamics
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device('cuda')
    res = {'card': card(), 'other': os.path.abspath(other_csrc),
           'kind': kind, 'turns': []}
    way = 'fwd' if kind.endswith('_fwd') else 'bwd'
    port = port_launcher(kind)
    with tempfile.TemporaryDirectory() as tmp:
        launchers = {'other': other_launcher(other_csrc, kind, tmp),
                     'this': port}
        try:
            model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
            convs = layer_inputs(model, kind, dev)
            atoms = build_nacl(1000)
            names = [SLOTS[kind][:2]]
            if kind.startswith('terms'):
                md = MolecularDynamics(model, atoms, device=dev,
                                       cg_mode='terms', **NPT_KW)
                calc = SevenNetCalculator(model, device=dev, cg_mode='terms')
                calc.calculate(atoms)
            else:
                md = MolecularDynamics(model, atoms, device=dev,
                                       half_mlp=True, **NVT_KW)
            for side in ('other', 'this', 'this', 'other'):
                install(kind, launchers[side])
                turn = {'side': side}
                for (layer, dd), (conv, ws, ins) in convs.items():
                    turn[f'layer{layer}_{dd}_{way}_ms'] = cuda_ms(
                        lambda: call(kind, conv, ws, ins))
                pos, nl = md.state.pos, md._grid()
                if kind.startswith('terms'):
                    cell = md.state.cell
                    fn = lambda: md._efs_fn(pos, nl, cell)   # noqa: E731
                    fn()
                    (turn[f'force_call_{way}_ms'],
                     turn['force_call_host_ms']) = timed_call(fn, names)
                    (turn[f'calculator_{way}_ms'],
                     turn['calculator_host_ms']) = timed_call(
                        lambda: calc.calculate(atoms), names)
                else:
                    fn = lambda: md._ef_fn(pos, nl)   # noqa: E731
                    fn()
                    (turn[f'force_call_{way}_ms'],
                     turn['force_call_host_ms']) = timed_call(fn, names)
                turn['md_ms_per_step'] = md_ms_per_step(md, steps)
                print(json.dumps({k: (round(v, 4) if isinstance(v, float)
                                      else v) for k, v in turn.items()}),
                      flush=True)
                res['turns'].append(turn)
            for (layer, dd), (conv, ws, ins) in convs.items():
                outs = {}
                for side in ('other', 'this'):
                    install(kind, launchers[side])
                    outs[side] = call(kind, conv, ws, ins)
                key = f'layer{layer}_{dd}_rel_diff'
                res[key] = [float((a - b).abs().max()
                                  / max(float(b.abs().max()), 1e-30))
                            for a, b in zip(outs['this'], outs['other'])]
                print(f'layer {layer} agg_d {dd}: the two builds differ by '
                      f'{res[key]} of max|other|', flush=True)
        finally:
            install(kind, port)
    for side in ('other', 'this'):
        turns = [t for t in res['turns'] if t['side'] == side]
        res[f'{side}_mean'] = {k: statistics.mean(t[k] for t in turns)
                               for k in turns[0] if k != 'side'}
        print(side, json.dumps({k: round(v, 4) for k, v in
                                res[f'{side}_mean'].items()}), flush=True)
    return res


# the micro-benchmark kinds: a bench tool's kernel from OTHER_CSRC against
# this tree's on the tool's own inputs (no model), and the source it is in
MICRO = {'dot_bf16': 'bench_dot.cu', 'outer': 'bench_cgmxu.cu',
         'st': 'bench_cgmxu.cu', 'cg_c': 'bench_cg.cu',
         'tp_bwd': 'fused_tp.cu', 'layout_transpose': 'bench_layout.cu',
         'tile_c': 'bench_tile.cu', 'tile_b': 'bench_tile.cu'}


def tile_launcher(lib: ctypes.CDLL, v: str):
    """fn(x, s) launching variant V ('d', 'a', 'b' or 'c', c with the
    ones-block T) of LIB, a build of a ``bench_tile.cu`` (entries
    ``tile_dab`` and ``tile_c``)."""
    lib.tile_dab.argtypes = [ctypes.c_char, _P, _P, _L, _P, _P]
    lib.tile_c.argtypes = [_P, _P, _P, _L, _P, _P]
    lib.tile_dab.restype = lib.tile_c.restype = _I

    def fn(x, s):
        out = x.new_empty((x.shape[0], bench_tile.MUL))
        T = bench_tile._device_T(x.device)
        args = (_ptr(x), _ptr(s), *((_ptr(T),) if v == 'c' else ()),
                x.shape[0], _ptr(out), _stream(out))
        err = (lib.tile_c(*args) if v == 'c' else
               lib.tile_dab(v.encode(), *args))
        cuda_build.check(err, f'tile_{v}')
        return out
    return fn


def micro_cases(kind: str, lib: ctypes.CDLL):
    """(label, other, this, ref, lim) for each input of KIND on the card:
    LIB's launch, this tree's, the plain version's output and the limit on
    max|out - ref| (a tuple of each for several outputs)."""
    if kind == 'tp_bwd':
        from ..checkpoint import SevenNetCheckpoint
        dev = torch.device('cuda')
        model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
        other_bwd = tp_launcher(lib, parent=True)
        for layer, (op, ins) in tp_inputs(model, dev).items():
            ref = op.plain_backward(*ins)
            yield (f'layer{layer}', lambda op=op, ins=ins: other_bwd(op, *ins),
                   lambda op=op, ins=ins: op.kernel_backward(*ins), ref,
                   tuple(1e-4 * float(r.abs().max()) for r in ref))
        return
    if kind == 'layout_transpose':
        x, y = bench_layout.make_inputs('cuda')
        for v in ('transpose', 'rowmajor'):
            fn = getattr(lib, f'layout_{v}')
            fn.argtypes = [_P, _P, _L, _P, _P]
            fn.restype = _I

            def other(fn=fn, v=v):
                out = x.new_empty((x.shape[0], bench_layout.MUL))
                cuda_build.check(fn(_ptr(x), _ptr(y), x.shape[0], _ptr(out),
                                    _stream(x)), f'other layout_{v}')
                return out
            ref = bench_layout.plain(v, x, y)
            yield (v, other, lambda v=v: bench_layout.forward(v, x, y), ref,
                   1e-4 * float(ref.abs().max()))
        return
    if kind in ('tile_c', 'tile_b'):
        copies = bench_tile.input_copies(*bench_tile.make_inputs(32768,
                                                                 'cuda'))
        for var in bench_tile.VARIANTS:
            if var[0] not in (kind[-1], 'd'):
                continue
            # a rotation's first call runs on copies[0]: the checked one
            ref = bench_tile.plain(var, *copies[0])
            yield (var, bench_tile.rotate(tile_launcher(lib, var[0]), copies),
                   bench_tile.rotate(
                       lambda x, s, var=var: bench_tile.forward(var, x, s),
                       copies), ref, 1e-4 * float(ref.abs().max()))
        return
    if kind == 'dot_bf16':
        fn = lib.dot_bf16
        fn.argtypes = [_P, _P, _I, _I, _I, _L, _P, _P]
        fn.restype = _I
        for K, M, N in bench_dot.SHAPES:
            C, Z = bench_dot.make_inputs(K, M, N, 'cuda')

            def other(C=C, Z=Z):
                g, K, N = Z.shape
                out = Z.new_empty((g, C.shape[1], N))
                cuda_build.check(fn(_ptr(C), _ptr(Z), g, K, C.shape[1], N,
                                    _ptr(out), _stream(C)), 'other dot_bf16')
                return out
            ref = bench_dot.plain('bf16', C, Z)
            yield ((K, M, N), other,
                   lambda C=C, Z=Z: bench_dot.forward('bf16', C, Z), ref,
                   1e-5 * K * float(ref.abs().max()))
        return
    if kind == 'cg_c':
        fn = lib.cg_c
        fn.argtypes = [_P] * 4 + [_L, _P, _P]
        fn.restype = _I
        v = 'c:full-width'
        x, y = bench_cg.make_inputs(32768, 'cuda')
        C, T = bench_cg._device_tables(x.device)

        def other_c():
            out = x.new_empty((x.shape[0], bench_cg.D3 * bench_cg.MUL))
            cuda_build.check(fn(*map(_ptr, (x, y, C, T)), x.shape[0],
                                _ptr(out), _stream(out)), 'other cg_c')
            return out
        ref = bench_cg.plain(v, x, y)
        yield ('E=32768', other_c, lambda: bench_cg.forward(v, x, y), ref,
               1e-4 * float(ref.abs().max()))
        return
    mode = kind
    if mode == 'st':
        fn = lib.cgmxu_st
        fn.argtypes = [_P] * 5 + [_I] + bench_cgmxu._CLS + [_P, _P]
    else:
        fn = lib.cgmxu_outer
        fn.argtypes = [_P] * 5 + bench_cgmxu._CLS + [_P, _P]
    fn.restype = _I
    for i1 in (1, 2):
        cls = bench_cgmxu.cg_class(i1)
        ins = bench_cgmxu.make_inputs(cls, 32768, 'cuda')
        recs, tab, row_ins, C = cls.device_tables(ins[0].device)
        tables = ((recs, tab), (tab.numel(),)) if mode == 'st' else \
            ((row_ins, C), ())

        def other(cls=cls, ins=ins, tables=tables):
            E = ins[0].shape[1]
            out = ins[0].new_empty((cls.wide, E))
            cuda_build.check(fn(*map(_ptr, (*ins, *tables[0])), *tables[1],
                                cls.mul, cls.d1, cls.f, len(cls.instrs),
                                cls.d3tot, E, _ptr(out), _stream(out)),
                             f'other {mode}')
            return out
        ref = bench_cgmxu.plain(cls, mode, *ins)
        yield (f'i1={i1}', other,
               lambda cls=cls, ins=ins: bench_cgmxu.forward(cls, mode, *ins),
               ref, 1e-4 * float(ref.abs().max()))


def run_micro(other_csrc: str, kind: str, reps: int = 20):
    res = {'card': card(), 'other': os.path.abspath(other_csrc),
           'kind': kind, 'cases': {}}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(os.path.join(other_csrc, MICRO[kind]),
                    os.path.join(tmp, f'lib_other_{kind}.so'))
        for label, other, this, ref, lim in micro_cases(kind, lib):
            row = res['cases'][str(label)] = {'other': [], 'this': []}
            for side, fn in (('other', other), ('this', this)):
                outs, refs, lims = fn(), ref, lim
                if not isinstance(refs, tuple):
                    outs, refs, lims = (outs,), (refs,), (lims,)
                errs = [float((o - r).abs().max())
                        for o, r in zip(outs, refs)]
                if not all(e <= m for e, m in zip(errs, lims)):
                    raise AssertionError(f'{kind} {label} {side}: |err| '
                                         f'{errs} > {lims}')
                row[f'err_{side}'] = errs if len(errs) > 1 else errs[0]
            del ref
            for side, fn in (('other', other), ('this', this),
                             ('this', this), ('other', other)):
                row[side].append(cuda_ms(fn, reps=reps))
            row['ratio'] = statistics.mean(row['other']) / statistics.mean(
                row['this'])
            print(f'{kind} {label}: other {row["other"][0]:.4f} / '
                  f'{row["other"][1]:.4f} ms, this {row["this"][0]:.4f} / '
                  f'{row["this"][1]:.4f} ms, other / this '
                  f'{row["ratio"]:.3f}', flush=True)
    for side in ('other', 'this'):
        res[f'{side}_sum'] = sum(statistics.mean(r[side])
                                 for r in res['cases'].values())
        print(f'{kind} summed, {side}: {res[f"{side}_sum"]:.4f} ms',
              flush=True)
    return res


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    kinds = [k for k in (*KINDS, *MICRO)
             if f'--{k.replace("_", "-")}' in argv]
    pos = [a for a in argv if not a.startswith('--')]
    if len(kinds) != 1 or not pos:
        print(next(ln.strip() for ln in __doc__.splitlines()
                   if 'python -m' in ln), file=sys.stderr)
        return 2
    if not require_card('bwd_ab'):
        return 2
    steps = int(pos[1]) if len(pos) > 1 and pos[1].isdigit() else 100
    res = (run_micro(pos[0], kinds[0]) if kinds[0] in MICRO else
           run(pos[0], kinds[0], steps))
    out = [a for a in pos if a.endswith('.json')]
    if out:
        os.makedirs(os.path.dirname(os.path.abspath(out[0])), exist_ok=True)
        with open(out[0], 'w') as fh:
            json.dump(res, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
