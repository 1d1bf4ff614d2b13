"""Deploy: a serving artifact that runs without the Python package.

Counterpart of ``sevennet_exp_tpu/scripts/deploy.py`` (reference
sevenn/scripts/deploy.py). Where the JAX package writes StableHLO for a
PJRT host, the port writes an AOTInductor package for a libtorch host
(``csrc/sevenn_exec.cpp``, the LAMMPS pair style
``lammps_pair/pair_sevennet_torch.cpp``). The artifact directory holds:

  - ``config.yaml``      the checkpoint's config (as JAX's)
  - ``meta.yaml``        JAX's serving metadata (chemical_symbols_to_index,
                         cutoff, comm_size(s), ...) plus ``device`` and
                         ``kernel_layers``, the convolutions the artifact
                         runs through the edge pair
  - ``state.pt``         the parameters, a flat {name: tensor} dict
  - ``signature.yaml``   the program's inputs in order (sorted names,
                         shapes, dtypes), its outputs and the capacities
                         n_node / n_edge: JAX's file, key for key
  - ``model_export.pt2`` the ``torch.export`` program (reload in Python)
  - ``model.pt2``        the AOTInductor package (the C++ host's program)

and, on the card, ``libsevenn_torch_ops.so`` (the dispatcher ops,
``csrc/torch_ops.cpp``) with the kernel libraries it opens
(``libfused_conv_geom.so``, and ``libfused_conv_geom_ssp.so`` for a
shifted-softplus model), so that the directory is all a host needs.

The program is ``SevenNetModel.apply`` on the plain edge list at fixed
capacities, returning (energy (1,), forces (n_node, 3), stress (1, 6)).
``make_fx`` flattens its forward and the autograd backward into one graph
(on fake tensors, so that no value of the example inputs is baked in),
``torch.export`` takes that graph and ``aoti_compile_and_package``
compiles it. On the card every convolution the edge pair takes is the
dispatcher op pair ``sevenn_torch::conv_edge_fwd`` / ``_bwd``, and a graph
that lacks them for such a layer raises; on the CPU the graph is the plain
chain. An export failure raises (JAX writes ``stablehlo_error.txt``).
Inputs follow ``collate_graphs``: pad atoms have Z = 0 and node mask 0,
pad edges the vector (1, 0, 0) and edge mask 0.
"""

from __future__ import annotations

import os
import shutil
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import _keys as KEY
from ..checkpoint import SevenNetCheckpoint
from ..data.periodic import chemical_symbols
from ..model import layers as L
from ..ops import cuda_build, torch_ops
from ..ops.fused_conv import USE_KERNELS_KEY

# the program's inputs, in the order of its arguments (JAX: sorted names)
INPUT_KEYS = tuple(sorted([
    KEY.ATOMIC_NUMBERS, KEY.EDGE_IDX, KEY.EDGE_VEC, KEY.EDGE_MASK,
    KEY.BATCH, KEY.NUM_ATOMS, KEY.NODE_MASK, KEY.CELL_VOLUME]))
_INT_INPUTS = (KEY.ATOMIC_NUMBERS, KEY.EDGE_IDX, KEY.BATCH, KEY.NUM_ATOMS)
OPS_LIBRARY = 'libsevenn_torch_ops.so'
_OPS = ('sevenn_torch.conv_edge_fwd', 'sevenn_torch.conv_edge_bwd')


def _comm_sizes(model) -> List[int]:
    """Per-convolution input feature widths (halo payload sizes)."""
    return [int(layer.tp.irreps_in1.dim) for layer in model.layers.values()
            if isinstance(layer, L.IrrepsConvolution)]


def example_inputs(n_node: int, n_edge: int, device='cpu'):
    """The program's inputs at its capacities, in ``INPUT_KEYS`` order (the
    JAX deploy's example data)."""
    data = {
        KEY.ATOMIC_NUMBERS: np.zeros(n_node, np.int32),
        KEY.EDGE_IDX: np.zeros((2, n_edge), np.int32),
        KEY.EDGE_VEC: np.ones((n_edge, 3), np.float32),
        KEY.EDGE_MASK: np.zeros(n_edge, np.float32),
        KEY.BATCH: np.zeros(n_node, np.int32),
        KEY.NUM_ATOMS: np.array([n_node], np.int32),
        KEY.NODE_MASK: np.ones(n_node, np.float32),
        KEY.CELL_VOLUME: np.array([1.0], np.float32),
    }
    return [torch.as_tensor(data[k], device=device) for k in INPUT_KEYS]


def efs_function(model, use_kernels: bool):
    """The program: flat inputs in ``INPUT_KEYS`` order -> (energy,
    forces, stress)."""
    def efs(*flat):
        data = dict(zip(INPUT_KEYS, flat))
        for k in _INT_INPUTS:
            data[k] = data[k].long()
        data[USE_KERNELS_KEY] = use_kernels
        out = model.apply(data)
        return (out[KEY.PRED_TOTAL_ENERGY], out[KEY.PRED_FORCE],
                out[KEY.PRED_STRESS])
    return efs


def trace(model, n_node: int, n_edge: int, device) -> torch.fx.GraphModule:
    """One flat graph of the program's forward and backward (make_fx on
    fake tensors). On the card the convolutions that the edge pair takes
    must appear as its op pair, once each: otherwise it raises."""
    from torch.fx.experimental.proxy_tensor import make_fx

    device = torch.device(device)
    cuda = device.type == 'cuda'
    if cuda:
        if torch.backends.cuda.matmul.allow_tf32:
            raise ValueError('torch.backends.cuda.matmul.allow_tf32 is set: '
                             'the artifact computes in float32')
        torch_ops.load()
    gm = make_fx(efs_function(model, use_kernels=cuda), tracing_mode='fake',
                 _allow_non_fake_inputs=True)(
        *example_inputs(n_node, n_edge, device))
    _constants_to(gm, device)
    check_graph(gm, len(kernel_layers(model)) if cuda else 0)
    return gm


def _constants_to(gm: torch.fx.GraphModule, device: torch.device):
    """Put the graph's tensor constants on ``device``. A tensor the model
    makes from host data (``torch.as_tensor(array, device=...)``: the SH
    coefficients) is recorded as a host constant and a copy to the device;
    left on the host, AOTInductor hands the host tensor to a device
    product."""
    for node in gm.graph.nodes:
        if node.op != 'get_attr':
            continue
        *path, name = node.target.split('.')
        owner = gm.get_submodule('.'.join(path))
        t = getattr(owner, name)
        if torch.is_tensor(t) and t.device != device:
            setattr(owner, name, t.to(device))


def check_graph(gm: torch.fx.GraphModule, want: int):
    """Raise unless the graph holds ``want`` forward and ``want``
    backward edge-pair op nodes."""
    found = op_counts(gm)
    if found != [want, want]:
        raise RuntimeError(
            f'the traced graph holds {found} edge-pair op nodes (fwd, bwd) '
            f'for {want} convolutions on the kernel route')


def op_counts(gm: torch.fx.GraphModule) -> List[int]:
    """[conv_edge_fwd, conv_edge_bwd] nodes in a graph."""
    names = [str(n.target) for n in gm.graph.nodes
             if n.op == 'call_function']
    return [sum(name.startswith(op) for name in names) for op in _OPS]


def kernel_layers(model) -> List[str]:
    """The convolutions the edge pair runs on the card."""
    return [r['layer'] for r in model.conv_routes(agg_d=0)
            if r['route'] == 'kernel']


def _kernel_libraries(model) -> List[str]:
    """The kernel libraries the model's edge-pair layers launch from."""
    names = kernel_layers(model)
    return sorted({torch_ops.kernel_library(model.layers[name]._conv(0)
                                            .act_code) for name in names})


def _write_yaml(path: str, obj):
    import yaml
    with open(path, 'w') as f:
        yaml.safe_dump(obj, f, default_flow_style=False)


def deploy(checkpoint: str, output_path: str = 'deployed_serial',
           n_node: int = 64, n_edge: int = 1024, device='cuda',
           with_program: bool = True, timings: Optional[Dict] = None
           ) -> str:
    """Write the artifact directory (see the module docstring); returns
    its path. ``with_program=False`` writes the metadata and parameters
    only (``deploy_parallel``). ``timings``, a dict, receives the seconds
    of the trace, the export and the AOTInductor compile."""
    device = torch.device(device)
    cp = SevenNetCheckpoint(checkpoint)
    model, state = cp.build_model(device=device)
    os.makedirs(output_path, exist_ok=True)
    _write_yaml(os.path.join(output_path, 'config.yaml'), {
        k: v for k, v in cp.config.items()
        if isinstance(v, (str, int, float, bool, list, dict, type(None)))})
    type_map = model.type_map
    sizes = _comm_sizes(model)
    meta = {
        'chemical_symbols_to_index': ' '.join(
            chemical_symbols[z]
            for z in sorted(type_map, key=lambda z: type_map[z])),
        'cutoff': float(model.cutoff),
        'num_species': len(type_map),
        'comm_size': max(sizes) if sizes else 0,
        'comm_sizes': sizes,
        'model_type': 'E3_equivariant_model',
        'version': '0.1.0+tpu',
        'dtype': 'single',
        'time': '',
        'device': device.type,
        'kernel_layers': kernel_layers(model) if device.type == 'cuda'
        else [],
    }
    _write_yaml(os.path.join(output_path, 'meta.yaml'), meta)
    torch.save({k: v.detach().cpu() for k, v in state.items()},
               os.path.join(output_path, 'state.pt'))
    if with_program:
        _export(model, output_path, n_node, n_edge, device,
                timings if timings is not None else {})
    return output_path


def _export(model, output_path, n_node, n_edge, device, timings):
    t0 = time.perf_counter()
    gm = trace(model, n_node, n_edge, device)
    t1 = time.perf_counter()
    inputs = example_inputs(n_node, n_edge, device)
    ep = torch.export.export(gm, tuple(inputs))
    torch.export.save(ep, os.path.join(output_path, 'model_export.pt2'))
    t2 = time.perf_counter()
    # the C++ of the package (its wrapper, and the CPU kernels) by the g++
    # on PATH, as every C++ build of the port: Inductor would take $CXX,
    # which need not link -fopenmp
    configs = {'cpp.cxx': (None, 'g++')}
    if device.type == 'cpu':
        # the CPU backend's vectorised codegen asserts on this graph
        # (PyTorch 2.13, an index store in a vector loop): compile it scalar
        configs['cpp.simdlen'] = 1
    torch._inductor.aoti_compile_and_package(
        ep, package_path=os.path.join(output_path, 'model.pt2'),
        inductor_configs=configs)
    timings.update(trace_s=t1 - t0, export_s=t2 - t1,
                   aoti_s=time.perf_counter() - t2)
    if device.type == 'cuda':
        shutil.copy(torch_ops.library_path(),
                    os.path.join(output_path, OPS_LIBRARY))
        for name in _kernel_libraries(model):
            shutil.copy(cuda_build.build(name),
                        os.path.join(output_path, f'lib{name}.so'))
    sig = {
        'inputs': [{'name': k, 'shape': list(t.shape),
                    'dtype': str(t.dtype).replace('torch.', '')}
                   for k, t in zip(INPUT_KEYS, inputs)],
        'outputs': [
            {'name': 'energy', 'shape': [1], 'dtype': 'float32'},
            {'name': 'forces', 'shape': [n_node, 3], 'dtype': 'float32'},
            {'name': 'stress', 'shape': [1, 6], 'dtype': 'float32'},
        ],
        'n_node': n_node,
        'n_edge': n_edge,
    }
    _write_yaml(os.path.join(output_path, 'signature.yaml'), sig)


def deploy_parallel(checkpoint: str, output_path: str = 'deployed_parallel',
                    device='cuda') -> str:
    """Reference deploy.py:73-148, as the JAX package has it: the payload
    of ``deploy`` without a program, with the per-convolution halo widths
    (``comm_sizes`` in meta.yaml) that a domain-decomposed engine sizes its
    exchanges by."""
    return deploy(checkpoint, output_path, device=device,
                  with_program=False)


def _read_yaml(path: str):
    import yaml
    with open(path) as f:
        return yaml.safe_load(f)


class Deployed:
    """A deployed artifact reloaded in Python: ``self(*inputs)`` takes the
    signature's inputs in order (numpy arrays or tensors) and returns
    (energy, forces, stress) tensors on the artifact's device.
    ``program``: 'aoti' (``model.pt2``, what the C++ host runs) or
    'export' (``model_export.pt2``)."""

    def __init__(self, path: str, program: str = 'aoti'):
        self.path = path
        self.meta = _read_yaml(os.path.join(path, 'meta.yaml'))
        self.signature = _read_yaml(os.path.join(path, 'signature.yaml'))
        self.device = torch.device(self.meta['device'])
        if self.device.type == 'cuda':
            _open_ops(path)
        if program == 'aoti':
            self._fn = torch._inductor.aoti_load_package(
                os.path.join(path, 'model.pt2'))
        elif program == 'export':
            self._fn = torch.export.load(
                os.path.join(path, 'model_export.pt2')).module()
        else:
            raise ValueError(f'program {program!r}: aoti or export')

    def __call__(self, *inputs):
        specs = self.signature['inputs']
        if len(inputs) != len(specs):
            raise ValueError(f'{len(inputs)} inputs, the signature has '
                             f'{len(specs)}')
        args = []
        for x, spec in zip(inputs, specs):
            t = torch.as_tensor(x, device=self.device,
                                dtype=getattr(torch, spec['dtype']))
            if list(t.shape) != spec['shape']:
                raise ValueError(f"{spec['name']}: shape {list(t.shape)} != "
                                 f"{spec['shape']}")
            args.append(t.contiguous())
        return tuple(self._fn(*args))


def _open_ops(path: str):
    """The ops for a card artifact: the package's shim (loaded once a
    process) on the package's build of each kernel library the artifact
    carries (the copies in the directory serve the C++ host)."""
    for name in torch_ops.KERNEL_LIBRARIES:
        if os.path.exists(os.path.join(path, f'lib{name}.so')):
            torch_ops.use_kernel_library(name)


def load_deployed(path: str, program: str = 'aoti') -> Deployed:
    """The counterpart of the JAX ``model.jaxexport`` reload."""
    return Deployed(path, program)
