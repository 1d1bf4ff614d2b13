"""Runs one cell of the benchmark of the PyTorch and CUDA port
(``sevennet_exp_tpu_torch``) and prints its result as one JSON line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic mix, limits and per-layer metric
readers are found by name (``BENCHMARK.json``, ``portbench/configs``,
``traffic``, ``limits``, ``metrics``). The process sets up the program on
inputs made from the seed, warms it, measures for ``--seconds``, checks
what the measured path produced against the plain reference, and prints
the compared numbers with their limits as the last lines of standard
error. ``--trace 1`` runs the window under ``torch.profiler`` and reports
the per-layer metrics instead of the end-to-end ones.
"""

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# top-level module names the run must not load: the JAX package and JAX
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'sevennet_exp_tpu')
GIB = float(1 << 30)


def process_start() -> float:
    """The process's start on the ``perf_counter`` clock (from the kernel's
    record of its start; the module's import time where that is not
    readable)."""
    try:
        with open('/proc/self/stat') as fh:
            ticks = int(fh.read().rsplit(')', 1)[1].split()[19])
        with open('/proc/uptime') as fh:
            uptime = float(fh.read().split()[0])
        age = uptime - ticks / os.sysconf('SC_CLK_TCK')
        return time.perf_counter() - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def loaded_forbidden():
    return sorted({m.split('.')[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(workload: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, mix=None, limits=None, cell=None):
    """(result, check lines) of one run, without the look for a chip: the
    tests drive this on the CPU. ``mix``, ``limits`` and ``cell`` (as
    ``manifest.cell`` gives it) replace the cell's own files and entry
    when given."""
    import torch

    from portbench.harness import manifest, md, traffic, train
    device = torch.device(device)
    if cell is None:
        cell = manifest.cell(workload, manifest.load_manifest(ROOT))
    w = cell['workload']
    mix = mix if mix is not None else traffic.load(w['traffic'])
    lim = limits if limits is not None else manifest.limits(workload)
    kind = {'md': md, 'train': train}[mix['kind']]
    out = kind.run(cell, mix, seed, seconds, trace, device, ROOT, t_start,
                   lambda ctx: manifest.per_layer_values(cell['per_layer'],
                                                         ctx))
    checks = {k: {'value': v, 'limit': lim.get(k)}
              for k, v in out['numbers'].items()}
    correct = bool(out['finite'] and all(
        c['limit'] is not None and c['value'] <= c['limit']
        for c in checks.values()))
    if trace:
        metrics = out['per_layer']
    else:
        values = {'ns_per_day': out.get('ns_per_day'),
                  'train_structures_per_s': out.get('structures_per_s'),
                  'peak_mem_gib': out['peak_bytes'] / GIB,
                  'setup_s': out['setup_s']}
        metrics = {m['name']: {'value': values[m['name']], 'unit': m['unit']}
                   for m in cell['end_to_end']}
    cuda = device.type == 'cuda'
    dev = {'platform': 'gpu' if cuda else 'cpu',
           'kind': torch.cuda.get_device_name(device) if cuda else 'cpu',
           'count': int(w['chips']), 'memory_peak_bytes': out['peak_bytes']}
    steps = out['window']['steps']
    result = {'correct': correct, 'attempted': steps,
              'failed': 0 if out['finite'] else steps, 'metrics': metrics,
              'device': dev}
    if trace:
        t = out['trace']
        dev['busy_s'] = t['busy_s']
        dev['window_s'] = t['window_s']
        result['breakdown'] = {'device_ops': t['device_ops'],
                               'idle_gaps': t['idle_gaps']}
    # the program's own counts over the window, beside the contract's keys
    result['counters'] = out.get('counters', {})
    result['checks'] = checks
    lines = [f'check {k}: {c["value"]!r} limit {c["limit"]!r}'
             for k, c in checks.items()]
    if not correct and out.get('detail'):
        lines.insert(0, out['detail'])
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start()
    sys.path.insert(0, ROOT)
    import torch

    # one process driving one card from one host thread: the program's
    # host work is Python dispatch, and idle intra-op workers only add
    # noise on a shared host
    torch.set_num_threads(1)

    from portbench.harness import manifest
    cell = manifest.cell(args.workload, manifest.load_manifest(ROOT))
    chips = int(cell['workload']['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{args.workload} needs {chips} CUDA device(s); found '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result, lines = execute(args.workload, args.seed, args.seconds,
                            bool(args.trace), 'cuda', t_start)
    bad = loaded_forbidden()
    if bad:
        print(f'the run loaded {bad}: the port must not load JAX or the JAX '
              'package', file=sys.stderr)
        return 3
    sys.stderr.write('\n'.join(lines) + '\n')
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
