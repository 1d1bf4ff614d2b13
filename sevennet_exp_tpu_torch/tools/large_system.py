"""Size the large-system (chunked) path on the card.

    python -m sevennet_exp_tpu_torch.tools.large_system [atoms]

On the chip_smoke.py system (trained_nacl checkpoint, NaCl rocksalt of
``atoms`` atoms, default 97336):

  1. engine start-up time (the t = 0 capacity sizing: a float64 neighbor
     count) with the engine on the card and with it on the host CPU;
  2. one force call per chunk size (rows per chunk: 32,768 to 1,048,576,
     and the geometry-fused path against the shared sh/emb path at the
     default size): milliseconds on the host clock after a warm call, in
     two turns, and peak device memory.

Prints one JSON line per measurement and writes them to
chiprun_out/large_system.json. The default chunk size in md/engine.py
(``CHUNK_ROWS``) was chosen from this table.
"""

import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CKPT = os.path.join(ROOT, 'trained_nacl', 'checkpoint_best.pth.sevennet')
CHUNK_ROWS = (32768, 65536, 131072, 262144, 524288, 1048576)


def main():
    if not torch.cuda.is_available():
        print('large_system: no CUDA device', file=sys.stderr)
        return 2
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import build_nacl
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics

    atoms = int(sys.argv[1]) if len(sys.argv) > 1 else 97336
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    structure = build_nacl(atoms)
    kw = dict(dt_fs=2.0, temperature_K=300.0, ensemble='nvt',
              rebuild_every=20, seed=0)
    out = []

    def emit(row):
        row['card'] = card
        out.append(row)
        print(json.dumps(row), flush=True)

    engines = {}
    for device in ('cuda', 'cpu', 'cuda'):      # the second cuda: warm
        model, _ = SevenNetCheckpoint(CKPT).build_model(device=device)
        t0 = time.perf_counter()
        md = MolecularDynamics(model, structure, device=device, **kw)
        if device == 'cuda':
            torch.cuda.synchronize()
        emit({'what': 'engine_startup', 'device': device, 'atoms': md.n,
              'seconds': time.perf_counter() - t0, 'deg_cap': md.deg_cap,
              'e_cap': md.e_cap, 'cell_cap': md.cell_cap})
        engines[device] = md
    md = engines['cuda']
    del engines
    nl = md._grid()
    pos = md.state.pos

    def force_call(chunk_rows, geom_fused):
        md.conv_chunk_atoms = chunk_rows // md.deg_cap
        md.geom_fused = geom_fused
        md._ef_fn(pos, nl)                      # warm
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        md._ef_fn(pos, nl)
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3,
                torch.cuda.max_memory_allocated())

    cases = [(rows, True) for rows in CHUNK_ROWS] + [(131072, False)]
    for turn in (0, 1):
        for rows, geom_fused in (cases if turn == 0 else cases[::-1]):
            ms, peak = force_call(rows, geom_fused)
            emit({'what': 'force_call', 'turn': turn, 'atoms': md.n,
                  'chunk_rows': md.conv_chunk_rows,
                  'chunks_per_layer': -(-md.e_cap_model
                                        // md.conv_chunk_rows),
                  'geom_fused': geom_fused, 'ms': ms,
                  'peak_memory_bytes': peak})
    out_dir = os.path.join(ROOT, 'chiprun_out')
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, 'large_system.json'), 'w') as fh:
        json.dump(out, fh, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
