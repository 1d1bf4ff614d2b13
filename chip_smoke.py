#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``sevennet_exp_tpu_torch``) on
one NVIDIA GPU: the 7net-0 NVT MD path at 1,000 atoms (whole-array
convolutions, kernels ``fused_conv_fwd`` / ``fused_conv_bwd``) and at
97,336 atoms (chunked convolutions, the geometry-fused kernels
``fused_conv_geom_fwd`` / ``fused_conv_geom_bwd``).

    python3 chip_smoke.py            # needs one CUDA card

Phases (any failure raises, exits non-zero and prints no result):
  1. card name and power limit; TF32 off; build the CUDA kernels
     (csrc/fused_conv.cu) with nvcc;
  2. each kernel against its plain PyTorch version on the 1k path's real
     inputs (trained checkpoint; kernels 1-2 on all five layers, the geom
     kernels on layers 0, 1 and 4 through the geometry-fused whole-array
     branch, so on the same grid): max abs error against the stated limit,
     median times, the bound;
  3. 1k energy and forces: kernel path against plain path; the
     geometry-fused branch against the default branch, with both times per
     force call; chunks of 96 atoms (a remainder chunk), geometry-fused
     and not, against the whole-array result;
  4. 1k NVT (300 K, 2 fs, rebuild every 20 steps): warm-up, then 200 timed
     steps with the launch counters reset just before them; every force
     call must have gone through 5 forward + 5 backward launches of
     kernels 1-2 and none of the geom kernels;
  5. 97,336 atoms: engine start-up time; the geom kernels against their
     plain versions on one full chunk of a mid layer; energy and forces of
     the chunked kernel path against the chunked plain path, each kernel
     launch of the force call timed; peak memory;
  6. 97k NVT, same settings: a 10-step warm-up (in which the engine
     settles its rebuild cadence), then 20 timed steps with the
     counters reset just before them; every force call must have launched
     5 x chunks geom forward and backward kernels and none of kernels 1-2;
  7. a ``{"kernels": [...]}`` line (all four kernels), then the card line
     and the result line ``{"ok": true, "device": {...}}`` last.

Imports nothing of JAX or of the JAX package. Details go to
``chiprun_out/chip_smoke.json``.
"""

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKPOINT = os.path.join(HERE, 'trained_nacl', 'checkpoint_best.pth.sevennet')

# H100 SXM published peaks (NVIDIA data sheet): fp32 outside the tensor
# cores and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# kernel vs plain version: max abs error <= REL_TOL * max|plain| (fp32,
# different summation order over up to ~26 rows x 256 products)
REL_TOL = 1e-4
# energy/forces of one path against another on the card
F_TOL = 1e-3           # eV/A
E_TOL_PER_ATOM = 1e-5  # eV/atom

N_LARGE = 97336        # 8 x 23^3: the large leg
MD_KW = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
             rebuild_every=20, seed=0)


def phase(name):
    print(f'== {name}', flush=True)


def bound(flops, nbytes):
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_mem), 'operations' if t_ops >= t_mem else 'bytes'


def check_close(what, got, ref):
    """max abs error of got against ref, held to REL_TOL * max|ref|."""
    err = float((got - ref).abs().max())
    lim = REL_TOL * float(ref.abs().max())
    if not (err <= lim and math.isfinite(err)):
        raise AssertionError(f'{what}: |err| {err:.3e} > {lim:.3e}')
    return err, lim


def check_ef(what, n, e_a, f_a, e_b, f_b):
    d_f = float((f_a - f_b).abs().max())
    d_e = abs(float(e_a) - float(e_b)) / n
    print(f'{what}: E {float(e_a):.6f} vs {float(e_b):.6f} eV; |dE|/N '
          f'{d_e:.3e} eV/atom (<= {E_TOL_PER_ATOM}); max|dF| {d_f:.3e} eV/A '
          f'(<= {F_TOL})', flush=True)
    if not (d_f <= F_TOL and d_e <= E_TOL_PER_ATOM):
        raise AssertionError(f'{what}: paths disagree')
    import torch
    if not (torch.isfinite(f_a).all() and torch.isfinite(f_b).all()):
        raise AssertionError(f'{what}: non-finite forces')
    return {'dE_per_atom': d_e, 'max_dF': d_f, 'energy': float(e_a),
            'energy_other': float(e_b)}


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, 'sevennet_exp_tpu_torch')):
        print('chip_smoke: sevennet_exp_tpu_torch/ not found beside the '
              'script', file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    out_dir = os.path.join(HERE, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    t_script = time.perf_counter()

    # -- phase 1 -------------------------------------------------------
    phase('1 card, precision, build')
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
    from sevennet_exp_tpu_torch.ops import fused_conv as fc
    from sevennet_exp_tpu_torch.tools.timing import cuda_ms
    t0 = time.perf_counter()
    lib = fc.build(verbose=True)
    report['build_s'] = time.perf_counter() - t0
    print(f'built {os.path.relpath(lib, HERE)} in {report["build_s"]:.1f} s',
          flush=True)
    dev = torch.device('cuda')
    report['card'] = card
    report['device'] = torch.cuda.get_device_name(0)
    FC = fc.FusedConv
    ROUTES = ('forward', 'backward', 'geom_forward', 'geom_backward')
    dispatch = {name: getattr(FC, name) for name in ROUTES}

    @contextlib.contextmanager
    def patched(**methods):
        """Swap FusedConv's dispatch methods, then put them back."""
        for name, fn in methods.items():
            setattr(FC, name, fn)
        try:
            yield
        finally:
            for name in methods:
                setattr(FC, name, dispatch[name])

    def plain_path():
        return patched(forward=FC.plain_forward, backward=FC.plain_backward,
                       geom_forward=FC.plain_geom_forward,
                       geom_backward=FC.plain_geom_backward)

    @contextlib.contextmanager
    def recorded(keep=lambda i: True):
        """Time every fused conv call of a force call with a pair of CUDA
        events, and record the inputs and the cotangent of the forward
        calls i for which keep(i) holds (i = layer * chunks + chunk).
        Yields (records, timings): a record is {'conv', 'call', 'geom',
        'args', 'g'}; timings map a route to [(event, event, conv, ms)]."""
        records, timings = {}, {name: [] for name in ROUTES}

        def wrap(name):
            fn = getattr(FC, name)
            is_geom, is_bwd = name.startswith('geom'), 'backward' in name
            ms_at = (2 if is_geom else 3) + is_bwd

            def wrapped(self, *args):
                idx = len(timings[name])
                if is_bwd:
                    # the backward visits the layers in reverse, each
                    # layer's chunks in order
                    per_layer = len(timings[name.replace('back', 'for')]) // 5
                    idx = (4 - idx // per_layer) * per_layer + idx % per_layer
                    if idx in records:
                        records[idx]['g'] = args[0].detach()
                elif keep(idx):
                    records[idx] = {
                        'conv': self, 'call': idx, 'geom': is_geom,
                        'args': tuple(a.detach() if torch.is_tensor(a) else a
                                      for a in args)}
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                out = fn(self, *args)
                b.record()
                timings[name].append((a, b, self, args[ms_at]))
                return out
            return wrapped

        with patched(**{name: wrap(name) for name in ROUTES}):
            yield records, timings

    def timed_ms(pairs):
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b, _, _ in pairs)

    def launch_cost(pairs, geom, which):
        flops = nbytes = 0.0
        for _, _, conv, ms in pairs:
            cost = fc.conv_cost(conv, ms, geom=geom)
            byt = fc.conv_bytes(conv, ms, geom=geom)
            flops += cost[0 if which == 'fwd' else 1]
            nbytes += byt[0 if which == 'fwd' else 1]
        return flops, nbytes

    def compare_kernels(rec, reps_plain=5):
        """One recorded launch: kernel against plain version, forward and
        backward, with median times and the bound."""
        conv, args, g, geom = rec['conv'], rec['args'], rec['g'], rec['geom']
        if geom:
            kf, kb = conv.kernel_geom_forward, conv.kernel_geom_backward
            pf, pb = conv.plain_geom_forward, conv.plain_geom_backward
            names, ms = ('dxg', 'dvec'), args[2]
        else:
            kf, kb = conv.kernel_forward, conv.kernel_backward
            pf, pb = conv.plain_forward, conv.plain_backward
            names, ms = ('dxg', 'dsh', 'demb'), args[3]
        row = {'rows': args[0].shape[0], 'd1': conv.d1, 'd_out': conv.d_out,
               'geom': geom}
        y_k, y_p = kf(*args), pf(*args)
        d_k, d_p = kb(g, *args), pb(g, *args)
        torch.cuda.synchronize()
        row['fwd_err'], row['fwd_lim'] = check_close('fwd', y_k, y_p)
        for name, a, b in zip(names, d_k, d_p):
            row[f'{name}_err'], row[f'{name}_lim'] = check_close(name, a, b)
        if geom:
            pad = ms.reshape(-1) == 0
            if float(d_k[1][pad].abs().max()) != 0.0 or float(
                    d_k[0][pad].abs().max()) != 0.0:
                raise AssertionError('pad rows of dxg/dvec are not zero')
        del y_k, y_p, d_k, d_p
        row['fwd_ms'] = cuda_ms(lambda: kf(*args))
        row['bwd_ms'] = cuda_ms(lambda: kb(g, *args))
        row['fwd_plain_ms'] = cuda_ms(lambda: pf(*args), reps=reps_plain)
        row['bwd_plain_ms'] = cuda_ms(lambda: pb(g, *args), reps=reps_plain)
        fwd_flops, bwd_flops, real = fc.conv_cost(conv, ms, geom=geom)
        fwd_bytes, bwd_bytes = fc.conv_bytes(conv, ms, geom=geom)
        row.update(real_rows=real, fwd_flops=fwd_flops, bwd_flops=bwd_flops,
                   fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes)
        for k in ('fwd', 'bwd'):
            row[f'{k}_bound_ms'], row[f'{k}_bound_by'] = bound(
                row[f'{k}_flops'], row[f'{k}_bytes'])
        return row

    def show(row):
        print(json.dumps({k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in row.items()}), flush=True)

    model, _ = SevenNetCheckpoint(CHECKPOINT).build_model(device=dev)
    atoms_1k = build_nacl(1000)
    md = MolecularDynamics(model, atoms_1k, device=dev, **MD_KW)
    md_geom = MolecularDynamics(model, atoms_1k, device=dev, geom_dense=True,
                                **MD_KW)
    n = md.n
    print(f'{n} atoms, deg_cap {md.deg_cap}, grid rows {md.e_cap_model}, '
          f'e_cap {md.e_cap}, cell list {md.use_cell_list}', flush=True)
    assert md.conv_chunk_rows == 0, 'the 1k path must not chunk'

    nl = md._grid()
    with recorded() as (records, _):
        e_k, f_k = md._ef_fn(md.state.pos, nl)
    with recorded(keep=lambda i: i in (0, 1, 4)) as (records_g, _):
        e_g, f_g = md_geom._ef_fn(md.state.pos, nl)
    torch.cuda.synchronize()
    records, records_g = list(records.values()), list(records_g.values())
    assert len(records) == 5 and not any(r['geom'] for r in records)
    assert len(records_g) == 3 and all(r['geom'] for r in records_g)

    # -- phase 2 -------------------------------------------------------
    phase('2 kernels vs plain versions (1k inputs)')
    layers = []
    for li, r in enumerate(records):
        row = dict(layer=li, **compare_kernels(r))
        show(row)
        layers.append(row)
    report['layers'] = layers
    geom_layers = []
    for r in records_g:
        row = dict(layer=r['call'], **compare_kernels(r))
        show(row)
        geom_layers.append(row)
    report['geom_layers_1k'] = geom_layers
    records = records_g = None

    # -- phase 3 -------------------------------------------------------
    phase('3 1k energy and forces')
    with plain_path():
        e_p, f_p = md._ef_fn(md.state.pos, nl)
    report['ef'] = check_ef('kernel path vs plain path', n, e_k, f_k, e_p,
                            f_p)
    report['ef_geom_dense'] = check_ef(
        'geometry-fused branch vs default branch', n, e_g, f_g, e_k, f_k)

    def force_call_ms(engine, reps=10):
        t0 = time.perf_counter()
        for _ in range(reps):
            engine._ef_fn(md.state.pos, nl)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    for engine in (md, md_geom):       # warm
        force_call_ms(engine, 3)
    turns = [force_call_ms(e) for e in (md, md_geom, md_geom, md)]
    report['force_call_ms_1k'] = {
        'default': [turns[0], turns[3]], 'geom_dense': [turns[1], turns[2]]}
    print(f'1k force call, host clock, in turns: default {turns[0]:.3f} / '
          f'{turns[3]:.3f} ms, geometry-fused {turns[1]:.3f} / '
          f'{turns[2]:.3f} ms', flush=True)

    report['ef_chunked_1k'] = {}
    for fused in (True, False):
        md_chunk = MolecularDynamics(model, atoms_1k, device=dev,
                                     conv_chunk_atoms=96, geom_fused=fused,
                                     **MD_KW)
        assert md_chunk.n % 96 and md_chunk.conv_chunk_rows == 96 * md.deg_cap
        fc.reset_launch_counts()
        e_c, f_c = md_chunk._ef_fn(md.state.pos, nl)
        want = dict.fromkeys(fc.launch_counts, 0)
        pair = 'fused_conv_geom' if fused else 'fused_conv'
        want[f'{pair}_fwd'] = want[f'{pair}_bwd'] = 5 * -(-n // 96)
        if fc.launch_counts != want:
            raise AssertionError('chunked 1k force call launched '
                                 f'{fc.launch_counts}, want {want}')
        report['ef_chunked_1k'][pair] = check_ef(
            f'chunks of 96 atoms (remainder 40), {pair} kernels, vs whole '
            'array', n, e_c, f_c, e_k, f_k)
    md_geom = md_chunk = None

    # -- phase 4 -------------------------------------------------------
    phase('4 1k NVT 300 K, dt 2 fs, rebuild every 20')

    def timed_nvt(engine, warm_steps, n_steps):
        t0 = time.perf_counter()
        engine.run(warm_steps)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        calls = [0]
        ef0 = engine._ef_fn

        def counted(pos, grid):
            calls[0] += 1
            return ef0(pos, grid)

        engine._ef_fn = counted
        fc.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = engine.run(n_steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fc.launch_counts)
        engine._ef_fn = ef0
        state = engine.state
        if not all(bool(torch.isfinite(t).all())
                   for t in (state.pos, state.vel, state.forces,
                             state.energy)):
            raise AssertionError('NaN/inf in the MD state')
        out = {'atoms': engine.n, 'steps': n_steps, 'warmup_s': warm_s,
               'wall_s': wall, 'ms_per_step': wall / n_steps * 1e3,
               'ns_per_day': n_steps / wall * 2.0 * 1e-6 * 86400.0,
               'final_temperature_K': float(metrics['temperature'][-1]),
               'force_calls': calls[0], 'launches': launches,
               'deg_cap': engine.deg_cap,
               'rebuild_every': engine.rebuild_every,
               'chunk_rows': engine.conv_chunk_rows,
               'energy': metrics['energy'].tolist()}
        print(f'{n_steps} steps in {wall:.3f} s: {out["ms_per_step"]:.3f} '
              f'ms/step, {out["ns_per_day"]:.4f} ns/day, final T '
              f'{out["final_temperature_K"]:.1f} K, force calls {calls[0]}, '
              f'launches {launches}', flush=True)
        return out

    def check_launches(nvt, per_call):
        for k, v in nvt['launches'].items():
            want = per_call.get(k, 0) * nvt['force_calls']
            if v != want or (per_call.get(k) and v == 0):
                raise AssertionError(
                    f'{k}: {v} launches for {nvt["force_calls"]} force '
                    f'calls (want {per_call.get(k, 0)} per call)')

    report['nvt'] = timed_nvt(md, 40, 200)
    check_launches(report['nvt'], {'fused_conv_fwd': 5, 'fused_conv_bwd': 5})
    md = nl = None
    torch.cuda.empty_cache()

    # -- phase 5 -------------------------------------------------------
    phase(f'5 {N_LARGE} atoms: chunked convolutions, geom kernels')
    t0 = time.perf_counter()
    atoms_big = build_nacl(N_LARGE)
    t_atoms = time.perf_counter() - t0
    t0 = time.perf_counter()
    big = MolecularDynamics(model, atoms_big, device=dev, **MD_KW)
    torch.cuda.synchronize()
    t_engine = time.perf_counter() - t0
    assert big.n == N_LARGE
    rows, chunk_rows = big.e_cap_model, big.conv_chunk_rows
    if not (chunk_rows > 0 and big._geom_packed_ok()):
        raise AssertionError('the 97k engine did not choose the chunked '
                             'geometry-fused path')
    chunks = -(-rows // chunk_rows)
    t0 = time.perf_counter()
    nl = big._grid()
    torch.cuda.synchronize()
    t_grid = time.perf_counter() - t0
    t0 = time.perf_counter()
    nl2 = big._compact_nl(big._verlet, big.state.pos)
    torch.cuda.synchronize()
    t_compact = time.perf_counter() - t0
    nl2 = None
    print(f'{big.n} atoms, deg_cap {big.deg_cap}, grid rows {rows}, chunk '
          f'rows {chunk_rows} ({chunks} chunks, remainder '
          f'{rows % chunk_rows} rows), e_cap {big.e_cap}, cell_cap '
          f'{big.cell_cap}; structure {t_atoms:.2f} s, engine start-up '
          f'{t_engine:.2f} s, first grid (Verlet build + compaction) '
          f'{t_grid:.2f} s, compaction alone {t_compact * 1e3:.1f} ms',
          flush=True)
    pos = big.state.pos
    big._ef_fn(pos, nl)                          # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # one full chunk of a mid layer: layer 1, chunk 0
    with recorded(keep=lambda i: i == chunks) as (records, timings):
        t0 = time.perf_counter()
        e_k, f_k = big._ef_fn(pos, nl)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    assert [len(timings[k]) for k in ROUTES] == [0, 0, 5 * chunks,
                                                 5 * chunks]
    geom_ms = {'fwd': timed_ms(timings['geom_forward']),
               'bwd': timed_ms(timings['geom_backward'])}
    geom_cost = {'fwd': launch_cost(timings['geom_forward'], True, 'fwd'),
                 'bwd': launch_cost(timings['geom_backward'], True, 'bwd')}
    print(f'97k force call {call_s * 1e3:.1f} ms on the host clock; geom '
          f'kernels {geom_ms["fwd"]:.1f} ms forward + {geom_ms["bwd"]:.1f} '
          f'ms backward in {5 * chunks} launches each; peak memory '
          f'{peak / 2 ** 30:.2f} GiB', flush=True)
    (rec,) = records.values()
    assert rec['args'][0].shape[0] == chunk_rows
    row = dict(layer=1, chunk=0, **compare_kernels(rec, reps_plain=3))
    show(row)
    report['geom_chunk_97k'] = row
    records = rec = timings = None
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with plain_path(), recorded(keep=lambda i: False) as (_, timings):
        e_p, f_p = big._ef_fn(pos, nl)
    torch.cuda.synchronize()
    peak_plain = torch.cuda.max_memory_allocated()
    print(f'plain path: peak memory {peak_plain / 2 ** 30:.2f} GiB',
          flush=True)
    plain_ms = {'fwd': timed_ms(timings['geom_forward']),
                'bwd': timed_ms(timings['geom_backward'])}
    timings = None
    report['ef_97k'] = check_ef('97k chunked kernel path vs chunked plain '
                                'path', big.n, e_k, f_k, e_p, f_p)
    report['large'] = {
        'atoms': big.n, 'deg_cap': big.deg_cap, 'grid_rows': rows,
        'chunk_rows': chunk_rows, 'chunks_per_layer': chunks,
        'structure_s': t_atoms, 'engine_startup_s': t_engine,
        'first_grid_s': t_grid, 'compaction_ms': t_compact * 1e3,
        'force_call_ms': call_s * 1e3, 'geom_kernel_ms': geom_ms,
        'geom_plain_ms': plain_ms, 'peak_memory_bytes': peak,
        'peak_memory_plain_bytes': peak_plain}
    e_p = f_p = e_k = f_k = None
    torch.cuda.empty_cache()

    # -- phase 6 -------------------------------------------------------
    phase('6 97k NVT 300 K, dt 2 fs, rebuild every 20')
    torch.cuda.reset_peak_memory_stats()
    report['nvt_97k'] = timed_nvt(big, 10, 20)
    report['nvt_97k']['peak_memory_bytes'] = torch.cuda.max_memory_allocated()
    report['nvt_97k']['chunks_per_layer'] = chunks
    print(f'chunk rows {chunk_rows}, {chunks} chunks per layer, peak memory '
          f'{report["nvt_97k"]["peak_memory_bytes"] / 2 ** 30:.2f} GiB',
          flush=True)
    check_launches(report['nvt_97k'], {'fused_conv_geom_fwd': 5 * chunks,
                                       'fused_conv_geom_bwd': 5 * chunks})

    # -- phase 7 -------------------------------------------------------
    phase('7 kernels')

    def total(key):
        return sum(r[key] for r in layers)

    source = 'sevennet_exp_tpu_torch/csrc/fused_conv.cu'
    kernels = []
    for name, k, line in (('fused_conv_fwd', 'fwd', 792),
                          ('fused_conv_bwd', 'bwd', 886)):
        errs = ([r['fwd_err'] for r in layers] if k == 'fwd' else
                [r[f'{d}_err'] for r in layers
                 for d in ('dxg', 'dsh', 'demb')])
        b_ms, b_by = bound(total(f'{k}_flops'), total(f'{k}_bytes'))
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['nvt']['launches'][name],
            'max_abs_err': max(errs),
            # per 1k force call: the five conv layers' launches
            'ms': total(f'{k}_ms'), 'plain_ms': total(f'{k}_plain_ms'),
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    geom_rows = geom_layers + [report['geom_chunk_97k']]
    for name, k, line in (('fused_conv_geom_fwd', 'fwd', 956),
                          ('fused_conv_geom_bwd', 'bwd', 970)):
        errs = ([r['fwd_err'] for r in geom_rows] if k == 'fwd' else
                [r[f'{d}_err'] for r in geom_rows for d in ('dxg', 'dvec')])
        b_ms, b_by = bound(*geom_cost[k])
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': f'sevennet_exp_tpu/ops/pallas_conv.py:{line}',
            'launches': report['nvt_97k']['launches'][name],
            'max_abs_err': max(errs),
            # per 97k force call: 5 layers x chunks launches, each timed
            'ms': geom_ms[k], 'plain_ms': plain_ms[k],
            'bound_ms': b_ms, 'bound_by': b_by, 'library_ms': None,
        })
    report['kernels'] = kernels
    report['script_s'] = time.perf_counter() - t_script
    print(f'whole script {report["script_s"]:.1f} s', flush=True)
    with open(os.path.join(out_dir, 'chip_smoke.json'), 'w') as fh:
        json.dump(report, fh, indent=1)
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
