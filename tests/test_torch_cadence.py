"""The port engine's adaptive rebuild cadence against the JAX engine's.

Mirrors tests/test_cadence.py:28-83 on the same tiny config and
``rattled_rocksalt``: the port's ``_cadence_ladder`` and ``_snap_cadence``
equal the JAX methods, and for the same largest displacement the port's
``_adjust_cadence`` moves ``rebuild_every`` where the JAX
``_postprocess_dispatch`` does, after a stale chunk (over md_buffer/2) and
after a quiet one (under 0.35 of it), with the hold in between. Then
``run`` itself, with the chunks' displacements scripted: one stale chunk
drops the cadence onto a rung, quiet ones climb it back to the configured
cadence.

Two port behaviours differ from the JAX engine on purpose: the port decides
after every chunk (JAX once per dispatch of several, on their maximum), and
it keeps a stale one-step chunk (JAX would re-run it unchanged).
"""

import jax
import numpy as np
import pytest
import torch

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.md.engine import MolecularDynamics as JMD
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch.checkpoint import params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.md.engine import MolecularDynamics
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model

torch.set_num_threads(2)
MD_KW = dict(dt_fs=1.0, temperature_K=100.0, ensemble='nvt', seed=0)


@pytest.fixture(scope='module')
def pair():
    config = tiny_model_config({'cutoff': 3.5, 'channel': 4, 'lmax': 1,
                                'num_convolution_layer': 2})
    jmodel = jbuild(config)
    jparams, _ = jmodel.init(jax.random.PRNGKey(1))
    model = build_e3_equivariant_model(config)
    model.load_state(params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, model


def _atoms():
    return rattled_rocksalt(reps=2, a=5.2, rattle=0.05, seed=3)


def _engines(pair, rebuild_every=20):
    jmodel, jparams, model = pair
    at = _atoms()
    jmd = JMD(jmodel, jparams, at, rebuild_every=rebuild_every, **MD_KW)
    md = MolecularDynamics(
        model, Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc),
        rebuild_every=rebuild_every, device='cpu', **MD_KW)
    assert md.md_buffer == pytest.approx(jmd.md_buffer, abs=1e-12)
    return jmd, md


def _metrics(worst):
    return {
        'overflow': np.array([False]),
        'overflow_deg': np.array([False]),
        'overflow_bin': np.array([False]),
        'max_disp2': np.array([worst ** 2]),
        'energy': np.array([0.0]),
        'temperature': np.array([100.0]),
    }


@pytest.mark.parametrize('rebuild_every', [20, 7])
def test_ladder_equals_jax(pair, rebuild_every):
    jmd, md = _engines(pair, rebuild_every)
    ladder = md._cadence_ladder()
    assert ladder == jmd._cadence_ladder()
    assert ladder == sorted(set(ladder)) and ladder[0] == 1
    assert ladder[-1] == rebuild_every


def test_snap_cadence_equals_jax(pair):
    jmd, md = _engines(pair)
    for k, want in [(20, 20), (19, 16), (9, 8), (7, 6), (1, 1), (0, 1)]:
        assert md._snap_cadence(k) == want, (k, want)
    for k in range(-1, 30):
        assert md._snap_cadence(k) == jmd._snap_cadence(k), k


# worst displacement in units of the bound md_buffer / 2
FRACTIONS = [10.0, 3.0, 1.5, 1.2, 1.01, 0.8, 0.5, 0.35, 0.34, 0.3, 0.01]


@pytest.mark.parametrize('start', [20, 16, 6, 2, 1])
def test_adjustment_equals_jax_postprocess(pair, start):
    jmd, md = _engines(pair)
    ladder = set(md._cadence_ladder())
    bound = 0.5 * md.md_buffer
    for frac in FRACTIONS:
        worst = frac * bound
        jmd.rebuild_every = md.rebuild_every = start
        out = jmd._postprocess_dispatch(jmd.state, _metrics(worst), 1)
        stale = md._adjust_cadence(worst)
        assert stale == (out is None) == (frac > 1.0), frac
        assert md.rebuild_every == jmd.rebuild_every, (start, frac)
        assert md.rebuild_every in ladder
        if stale:
            assert md.rebuild_every < start or start == 1


def test_recovery_steps_one_rung_with_hysteresis(pair):
    jmd, md = _engines(pair)
    bound = 0.5 * md.md_buffer
    md.rebuild_every = 6
    assert md._adjust_cadence(0.3 * bound) is False
    assert md.rebuild_every == 8            # one rung up, not +2
    # above the hysteresis, below the bound: hold
    md.rebuild_every = 6
    assert md._adjust_cadence(0.8 * bound) is False
    assert md.rebuild_every == 6
    jmd.rebuild_every = 6
    jmd._postprocess_dispatch(jmd.state, _metrics(0.8 * bound), 1)
    assert jmd.rebuild_every == 6
    # never above the configured cadence
    md.rebuild_every = 20
    md._adjust_cadence(0.01 * bound)
    assert md.rebuild_every == 20


def test_run_drops_onto_a_rung_and_climbs_back(pair):
    """One stale chunk (1.2x the bound) drops 20 to the rung under
    20 * 0.7 / 1.2 = 11.7, so 10, and re-runs it; quiet chunks (0.1x) then
    climb 10 -> 12 -> 16 -> 20 and stay there."""
    _, md = _engines(pair)
    bound = 0.5 * md.md_buffer
    script = [1.2 * bound] + [0.1 * bound] * 5
    real = md._max_disp
    seen = []

    def scripted(*args):
        if len(args) == 2:       # the Verlet list's own staleness test
            return real(*args)
        seen.append(script[len(seen)])
        return torch.tensor(seen[-1])

    md._max_disp = scripted
    out = md.run(10 + 12 + 16 + 20 + 20)
    assert out['steps'].tolist() == [10, 12, 16, 20, 20]
    assert md.rebuild_every == 20
    assert len(seen) == 6                   # the stale chunk ran twice
    assert np.isfinite(out['energy']).all()
