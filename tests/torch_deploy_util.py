"""Shared pieces of the deploy tests (``test_torch_deploy.py``,
``test_torch_native_host.py``, ``test_torch_lammps_pair.py``): a tiny JAX
checkpoint, two padded rattled structures with different edge counts, the
program's inputs in signature order and the JAX ``model.apply`` reference.

The tiny config is cut to two convolutions at lmax 1 so that each file's
AOTInductor compile of the CPU artifact stays near 30 s."""

import os

import jax
import jax.numpy as jnp
import numpy as np

from samples import rattled_rocksalt, tiny_model_config
from sevennet_exp_tpu import _keys as JKEY
from sevennet_exp_tpu.checkpoint import SevenNetCheckpoint as JCK
from sevennet_exp_tpu.checkpoint import save_checkpoint as jsave
from sevennet_exp_tpu.data.graph import (
    collate_graphs,
    unlabeled_atoms_to_graph,
)
from sevennet_exp_tpu.model.build import build_e3_equivariant_model as jbuild

N_NODE, N_EDGE = 24, 512
E_TOL, F_TOL, S_TOL = 1e-4, 1e-4, 1e-5
# cutoff 4.0: a = 3.6 gives two neighbour shells, a = 4.2 one
LATTICES = (3.6, 4.2)


def tiny_checkpoint(directory) -> str:
    path = os.path.join(str(directory), 'tiny.pth.sevennet')
    cfg = tiny_model_config({'num_convolution_layer': 2, 'lmax': 1})
    params, _ = jbuild(cfg).init(jax.random.PRNGKey(5))
    jsave(path, cfg, params, epoch=1)
    return path


def structure(a, seed=3):
    """16-atom rattled CsCl-type NaCl of lattice constant ``a``."""
    return rattled_rocksalt(a=a, reps=2, rattle=0.1, seed=seed)


def batch(at, cutoff):
    """The JAX package's padded single-graph batch (numpy)."""
    g = unlabeled_atoms_to_graph(at, cutoff)
    return {k: np.asarray(v) for k, v in
            collate_graphs([g], n_node=N_NODE, n_edge=N_EDGE).items()}


def program_inputs(b, signature):
    """The batch's arrays in the signature's order and dtypes."""
    out = []
    for spec in signature['inputs']:
        arr = np.ascontiguousarray(b[spec['name']].astype(spec['dtype']))
        assert list(arr.shape) == spec['shape'], spec['name']
        out.append(arr)
    return out


def jax_reference(checkpoint, b):
    """(E, F, S) of JAX ``model.apply`` on the batch: E (1,), F (N_NODE,
    3), S (1, 6)."""
    model, params = JCK(checkpoint).build_model()
    data = {k: jnp.asarray(v) for k, v in b.items()}
    data[JKEY.ATOMIC_NUMBERS] = data[JKEY.ATOMIC_NUMBERS].astype(jnp.int32)
    out = model.apply(params, data)
    return (np.asarray(out[JKEY.PRED_TOTAL_ENERGY]),
            np.asarray(out[JKEY.PRED_FORCE]),
            np.asarray(out[JKEY.PRED_STRESS]))


def assert_efs_close(got, want):
    e, f, s = (np.asarray(x, np.float64) for x in got)
    we, wf, ws = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_allclose(e.reshape(-1), we.reshape(-1), rtol=0,
                               atol=E_TOL)
    np.testing.assert_allclose(f, wf, rtol=0, atol=F_TOL)
    np.testing.assert_allclose(s.reshape(-1), ws.reshape(-1), rtol=0,
                               atol=S_TOL)
