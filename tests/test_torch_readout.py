"""The FCN readout and the three committed checkpoints on the CPU against
the JAX package.

  - ``readout_as_fcn``: a tiny model whose energy is read out by a scalar
    MLP (``FCNReadout``, in place of the two linears), weights from the JAX
    ``init`` on a seed, carried across by ``params_from_numpy``: calculator
    E/F/S against JAX, from config and from a checkpoint the JAX package
    wrote, at two activations;
  - ``trained_nacl``, ``trained_hfo2`` and ``trained_hfo2_v2`` through the
    port's calculator against the JAX calculator on a rattled structure of
    their species, and every convolution of the three on the kernel route.

Tolerances: 1e-4 eV, 1e-4 eV/A, 1e-5 eV/A^3 (fp32 both sides).
"""

import jax
import numpy as np
import pytest
import torch

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu.calculator import SevenNetCalculator as JCalc
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild
from sevennet_exp_tpu_torch.calculator import SevenNetCalculator
from sevennet_exp_tpu_torch.checkpoint import SevenNetCheckpoint, \
    params_from_numpy
from sevennet_exp_tpu_torch.data.graph import Atoms
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.layers import FCNReadout

torch.set_num_threads(2)
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5


def _close(res, ref):
    assert abs(res['energy'] - ref['energy']) <= max(
        E_TOL, 4 * float(np.spacing(np.float32(abs(ref['energy'])))))
    assert np.abs(res['energies'] - ref['energies']).max() <= E_TOL
    assert np.abs(res['forces'] - ref['forces']).max() <= F_TOL
    assert np.abs(res['stress'] - ref['stress']).max() <= S_TOL


def _port(at):
    return Atoms(at.atomic_numbers, at.pos, at.cell, at.pbc)


@pytest.mark.parametrize('act', ['relu', 'silu'])
def test_fcn_readout_matches_jax(act, tmp_path):
    cfg = tiny_model_config({'cutoff': 4.0, 'channel': 4, 'lmax': 1,
                             'num_convolution_layer': 2,
                             'readout_as_fcn': True,
                             'readout_fcn_hidden_neurons': [12, 6],
                             'readout_fcn_activation': act})
    jm = jbuild(cfg)
    jp, _ = jm.init(jax.random.PRNGKey(7))
    m = build_e3_equivariant_model(cfg)
    m.load_state(params_from_numpy(jax.tree_util.tree_map(np.asarray, jp)))
    assert 'reduce_input_to_hidden' not in m.layers
    readout = m.layers['readout_FCN']
    assert isinstance(readout, FCNReadout)
    assert readout.spec.hs == (m.layers['1_equivariant_gate'].spec
                               .irreps_out.dim, 12, 6, 1)
    assert list(m.layers).index('readout_FCN') == \
        list(m.layers).index('rescale_atomic_energy') - 1
    at = rattled_rocksalt(reps=2, a=3.2, rattle=0.05, seed=2)
    ref = JCalc(model=jm, params=jp, use_pallas=False).calculate_single(at)
    _close(SevenNetCalculator(m, device='cpu').calculate(_port(at)), ref)
    # the readout's weights move the energy (it is not bypassed)
    m.layers['readout_FCN'].p.w2.mul_(2.0)
    moved = SevenNetCalculator(m, device='cpu').calculate(_port(at))
    assert abs(moved['energy'] - ref['energy']) > 1e-3
    path = str(tmp_path / 'fcn.sevennet')
    jsave(path, cfg, jp)
    jm2, jp2 = JCK(path).build_model()
    _close(SevenNetCalculator(path, device='cpu').calculate(_port(at)),
           JCalc(model=jm2, params=jp2,
                 use_pallas=False).calculate_single(at))


@pytest.mark.parametrize('name', ['trained_nacl', 'trained_hfo2',
                                  'trained_hfo2_v2'])
def test_committed_checkpoints_match_jax(name):
    path = f'{name}/checkpoint_best.pth.sevennet'
    jm, jp = JCK(path).build_model()
    model, _ = SevenNetCheckpoint(path).build_model(device='cpu')
    zs = sorted(model.type_map)
    at = rattled_rocksalt(specie_a=zs[0], specie_b=zs[-1], reps=2, a=4.6,
                          rattle=0.1, seed=11)
    ref = JCalc(model=jm, params=jp, use_pallas=False).calculate_single(at)
    res = SevenNetCalculator(model, device='cpu').calculate(_port(at))
    _close(res, ref)
    assert np.abs(ref['forces']).max() > 10 * F_TOL
    assert all(r['route'] == 'kernel' for r in model.conv_routes(0))
