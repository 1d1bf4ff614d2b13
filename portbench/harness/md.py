"""An MD cell: the program's ``MolecularDynamics`` (NVT) on a structure and
velocities made from the seed, a measured window of whole chunks of the
engine's cadence, and the check of steps across the window against the
plain reference.

What is compared (after the window, the program's state freed): the
window's last step, and the first step after each of ``CHECK_BUILDS``
Verlet-list builds drawn from the seed across the window (one from each
of that many equal parts of the window's builds), since a wrong list
stays wrong until the next build. For each, the reference follows the
step from the program's own state before it (positions, velocities,
forces, thermostat) -- the Nose-Hoover step, the neighbour pairs worked
out again at the new positions, the model energy and its forces -- and
the program's forces and velocities after that step are held to it; the
widest gap over the steps is the number compared.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable, Dict, List

import numpy as np
import torch

from ..reference import checkpoint as ref_ckpt
from ..reference.integrate import masses as ref_masses
from ..reference.integrate import nose_hoover_step
from ..reference.model import ReferenceModel, build_specs, energy_forces
from ..reference.neighbors import edge_list
from . import trace as tr
from . import traffic

FS_PER_NS = 1e6
S_PER_DAY = 86400.0
# builds whose first step is held to the reference, besides the last step:
# each costs one reference step after the window
CHECK_BUILDS = 3
# the configuration's sizes that must equal the checkpoint's own
MODEL_KEYS = ('cutoff', 'lmax', 'num_convolution_layer', 'irreps_manual',
              'radial_basis', 'cutoff_function', 'weight_nn_hidden_neurons',
              'act_radial', 'act_scalar', 'act_gate', 'self_connection_type',
              'is_parity', 'use_bias_in_linear')


class StepTap:
    """Keeps the input and output state of the engine's latest step and,
    while ``keep`` is on, copies of those of the first step after every
    Verlet-list build; counts the steps (each one force call) and the
    builds. The step and the build themselves are the program's."""

    def __init__(self, engine):
        self.prev = self.last = None
        self.calls = self.builds = 0
        self.keep, self.after_build = False, False
        self.kept: List = []
        make, build = engine._make_step, engine._build_nl

        def counted_build(*args, **kwargs):
            self.builds += 1
            self.after_build = True
            return build(*args, **kwargs)

        engine._build_nl = counted_build

        def tapped_make():
            step = make()

            def tapped(state, nl):
                out = step(state, nl)
                self.prev, self.last = state, out
                self.calls += 1
                if self.after_build and self.keep:
                    self.kept.append((_state(state), _state(out)))
                self.after_build = False
                return out

            return tapped

        engine._make_step = tapped_make


def checkpoint_config(cfg: Dict, root: str) -> Dict:
    """The checkpoint the configuration names, after checking that it is
    the file the configuration was written for and has its sizes."""
    path = f"{root}/{cfg['checkpoint']}"
    if ref_ckpt.sha256(path) != cfg['checkpoint_sha256']:
        raise RuntimeError(f"{cfg['checkpoint']}: not the checkpoint this "
                           'configuration names (sha256 differs)')
    ck = ref_ckpt.load(path)
    for k in MODEL_KEYS:
        if ck['config'].get(k) != cfg['model'][k]:
            raise RuntimeError(f'checkpoint {k} = {ck["config"].get(k)!r}, '
                               f'configuration {cfg["model"][k]!r}')
    return {'path': path, **ck}


def program_setup(cfg: Dict, mix: Dict, inputs: Dict, seed: int, device,
                  ckpt_path: str):
    """The program's engine on the generated inputs (the system under
    test), warmed on its own shapes."""
    from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint
    from sevennet_exp_tpu_torch.data.graph import Atoms
    from sevennet_exp_tpu_torch.md.engine import MolecularDynamics

    model, _ = SevenNetCheckpoint(ckpt_path).build_model(device)
    atoms = Atoms(atomic_numbers=inputs['z'], pos=inputs['pos'],
                  cell=inputs['cell'], pbc=np.array([True] * 3))
    md = MolecularDynamics(
        model, atoms, dt_fs=mix['dt_fs'], temperature_K=mix['temperature_K'],
        ensemble=mix['ensemble'], tdamp_fs=mix['tdamp_fs'],
        rebuild_every=mix['rebuild_every'], seed=seed % (1 << 63),
        device=device, velocities=inputs['vel'])
    tap = md._tap = StepTap(md)
    md.run(int(mix['warm_steps']))
    return md, tap


def _sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def window(md, seconds: float, device, prof=None) -> Dict:
    """Whole chunks of the engine's cadence until ``seconds`` have passed;
    every step and all the time count."""
    from sevennet_exp_tpu_torch.ops import cuda_build
    before = dict(cuda_build.launch_counts)
    calls0, builds0 = md._tap.calls, md._tap.builds
    md._tap.kept, md._tap.keep = [], True
    chunk_steps = []
    mark = (torch.profiler.record_function(tr.WINDOW_MARK) if prof
            else None)
    _sync(device)
    t0 = time.perf_counter()
    if mark:
        mark.__enter__()
    while True:
        rows = md.run(md.rebuild_every)
        chunk_steps += [int(s) for s in rows['steps']]
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    if mark:
        mark.__exit__(None, None, None)
    wall = time.perf_counter() - t0
    md._tap.keep = False
    launches = {k: v - before.get(k, 0)
                for k, v in cuda_build.launch_counts.items()}
    return {'t0': t0, 'wall_s': wall, 'steps': sum(chunk_steps),
            'chunk_steps': chunk_steps, 'launches': launches,
            'force_calls': md._tap.calls - calls0,
            'verlet_builds': md._tap.builds - builds0}


def reference_step(ck: Dict, cfg: Dict, mix: Dict, inputs: Dict, prev: Dict,
                   device, ref: ReferenceModel = None) -> Dict:
    """The reference's step from the program's state ``prev``."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get('tf32', False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get('tf32', False))
    if ref is None:
        ref = ReferenceModel(cfg['model'], ck['params'],
                             ck['config']['_type_map'], device)
    z = inputs['z']
    cell_t = torch.as_tensor(inputs['cell'], dtype=torch.float32,
                             device=device)

    def energy(pos):
        return ref.energy(pos, z, edge_list(pos, cell_t, ref.cutoff))

    m = ref_masses(z, device)
    pos, vel, xi, e, f = nose_hoover_step(
        prev['pos'], prev['vel'], prev['forces'], prev['xi'], m,
        mix['dt_fs'], mix['temperature_K'], mix['tdamp_fs'],
        lambda p: energy_forces(energy, p))
    return {'pos': pos, 'vel': vel, 'xi': xi, 'energy': e, 'forces': f}


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The numbers compared: the widest force gap (eV/A) and the widest
    velocity gap over the reference's rms velocity. The energy is not
    compared: at 1e3-1e5 eV a total's float32 step (up to ~1e-3 eV)
    hides the control's error in it."""
    v_rms = torch.sqrt(torch.mean(ref['vel'].double() ** 2))
    return {
        'force_err': float(torch.max(torch.abs(
            got['forces'].double() - ref['forces'].double()))),
        'velocity_err': float(torch.max(torch.abs(
            got['vel'].double() - ref['vel'].double())) / v_rms),
    }


def _state(s) -> Dict[str, torch.Tensor]:
    return {k: getattr(s, k).detach().clone()
            for k in ('pos', 'vel', 'forces', 'energy', 'xi')}


def checked_steps(tap: StepTap, seed: int) -> List:
    """(label, state before, state after) of the steps held to the
    reference: the first step after one build drawn from each of
    ``CHECK_BUILDS`` equal parts of the window's builds, and the last."""
    kept = tap.kept
    parts = (np.array_split(np.arange(len(kept)),
                            min(CHECK_BUILDS, len(kept))) if kept else [])
    gen = traffic.rng(seed, 3)
    out = []
    for part in parts:
        i = int(part[gen.integers(len(part))])
        out.append((f'first step after build {i + 1} of {len(kept)}',
                    *kept[i]))
    out.append(('last step', _state(tap.prev), _state(tap.last)))
    return out


def check(ck: Dict, cfg: Dict, mix: Dict, inputs: Dict, steps: List,
          device) -> Dict[str, Any]:
    """The widest gaps over ``steps`` (see ``compare``), and where the
    widest force gap lies."""
    ref_model = ReferenceModel(cfg['model'], ck['params'],
                               ck['config']['_type_map'], device)
    numbers: Dict[str, float] = {}
    worst = (-1.0, '')
    for label, prev, got in steps:
        ref = reference_step(ck, cfg, mix, inputs, prev, device, ref_model)
        for k, v in compare(got, ref).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        gap = torch.max(torch.abs(got['forces'] - ref['forces']), dim=1).values
        i = int(torch.argmax(gap))
        if float(gap[i]) > worst[0]:
            worst = (float(gap[i]), (
                f'widest force gap, {label}, at atom {i} (Z '
                f'{int(inputs["z"][i])}): program {got["forces"][i].tolist()}'
                f' reference {ref["forces"][i].tolist()}'))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {'numbers': numbers, 'detail': worst[1]}


def run(cell: Dict, mix: Dict, seed: int, seconds: float, trace: bool,
        device, root: str, t_start: float,
        readers: Callable[[Dict], Dict]) -> Dict[str, Any]:
    """One run of an MD cell on the traffic mix ``mix``; returns the
    result's fields."""
    cfg = cell['config']
    inputs = traffic.md_inputs(mix, seed)
    ck = checkpoint_config(cfg, root)
    md, tap = program_setup(cfg, mix, inputs, seed, device, ck['path'])
    if device.type == 'cuda':
        torch.cuda.synchronize()
    prof = tr.profiler() if trace else None
    if prof:
        prof.start()
    setup_s = time.perf_counter() - t_start
    win = window(md, seconds, device, prof)
    if prof:
        prof.stop()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == 'cuda' else 0)
    if tap.last is not md.state:
        raise RuntimeError('the tapped step is not the engine\'s last state')
    steps = checked_steps(tap, seed)
    finite = all(bool(torch.isfinite(t).all())
                 for _, _, got in steps for t in got.values())
    out = {'setup_s': setup_s, 'window': win, 'peak_bytes': peak,
           'n': md.n, 'finite': finite,
           'counters': {'steps': win['steps'],
                        'force_calls': win['force_calls'],
                        'verlet_builds': win['verlet_builds'],
                        'steps_checked': len(steps),
                        'chunks': len(win['chunk_steps']),
                        'grid_degree': md.deg_cap, 'verlet_cap': md.e_cap}}
    if trace:
        t = tr.read(prof)
        del prof
        last = steps[-1][2]
        edges = edge_list(last['pos'], torch.as_tensor(
            inputs['cell'], device=device), float(cfg['model']['cutoff']))
        chunk_rows = md.conv_chunk_rows
        ctx = {
            'kind': 'md', 'trace': t, 'window_s': win['wall_s'],
            'steps': win['steps'], 'chunk_steps': win['chunk_steps'],
            'force_calls': win['force_calls'], 'launches': win['launches'],
            'specs': build_specs(cfg['model']),
            'degrees': torch.bincount(edges[0],
                                      minlength=md.n).cpu().numpy(),
            'deg_cap': md.deg_cap, 'chunk_rows': chunk_rows,
            'geom': bool(chunk_rows), 'device': device,
        }
        out['per_layer'] = readers(ctx)
        out['trace'] = t
    deg_cap = md.deg_cap
    tap.prev = tap.last = None
    tap.kept = []
    del md, tap
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    got = check(ck, cfg, mix, inputs, steps, device)
    out['numbers'] = got['numbers']
    out['detail'] = (f"{got['detail']}; chunks of the window "
                     f"{win['chunk_steps'][-12:]}, grid degree {deg_cap}")
    dt_ns = mix['dt_fs'] / FS_PER_NS
    out['ns_per_day'] = win['steps'] * dt_ns / win['wall_s'] * S_PER_DAY
    return out


def calibrate(cell: Dict, mix: Dict, seed: int, seconds: float, device,
              root: str, control: bool = True) -> Dict[str, Dict[str, float]]:
    """The readings of one seed: the program against the reference, and
    with ``control`` the control -- the reference in the nearest precision
    below the one the configuration states (TF32 matmuls) in the program's
    place -- against the same reference, on the same steps."""
    cfg = cell['config']
    inputs = traffic.md_inputs(mix, seed)
    ck = checkpoint_config(cfg, root)
    md, tap = program_setup(cfg, mix, inputs, seed, device, ck['path'])
    window(md, seconds, device)
    steps = checked_steps(tap, seed)
    tap.prev = tap.last = None
    tap.kept = []
    del md, tap
    gc.collect()
    torch.cuda.empty_cache()
    out = {'program': check(ck, cfg, mix, inputs, steps, device)['numbers']}
    if control:
        # the control's steps in the program's place, from the same states
        lower = dict(cfg, tf32=True)
        ref_model = ReferenceModel(cfg['model'], ck['params'],
                                   ck['config']['_type_map'], device)
        ctrl = [(label, prev, reference_step(ck, lower, mix, inputs, prev,
                                             device, ref_model))
                for label, prev, _ in steps]
        out['control'] = check(ck, cfg, mix, inputs, ctrl, device)['numbers']
    return out
