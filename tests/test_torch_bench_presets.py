"""The port's presets, species helpers, kernel build and micro-benchmark
entry points on the CPU.

The presets and ``chemical_species_preprocess`` are copies of the JAX
package's: the dicts must be equal, and both packages must build the same
layers from them (irreps of every convolution, its radial MLP widths and
its si2). The micro-benchmark tools build the 7net-0 mid layer from
``sevennet_0_config(species=['Na', 'Cl'])``, so that is the layer pinned
here. The build hashes a source together with the headers it includes, so
an edit of a shared header builds every library that includes it anew. The
tools refuse to run without a card (they time kernels that have no CPU
mode).
"""

import os
import shutil

import pytest
import torch

from sevennet_exp_tpu import presets as jax_presets
from sevennet_exp_tpu import util as jax_util
from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import \
    build_e3_equivariant_model as jax_build
from sevennet_exp_tpu_torch import presets, util
from sevennet_exp_tpu_torch.model.build import build_e3_equivariant_model
from sevennet_exp_tpu_torch.model.layers import IrrepsConvolution
from sevennet_exp_tpu_torch.ops import cuda_build
from sevennet_exp_tpu_torch.tools import (bench_cg, bench_cgmxu, bench_dot,
                                          bench_layout, bench_pieces,
                                          bench_tile)

PRESETS = ['sevennet_0_config', 'sevennet_l3i5_config']
SPECIES = [['Na', 'Cl'], ['Hf', 'O', 'Hf'], None]


@pytest.mark.parametrize('species', SPECIES, ids=['NaCl', 'HfO', 'universal'])
@pytest.mark.parametrize('name', PRESETS)
def test_presets_equal_jax(name, species):
    assert getattr(presets, name)(species) == \
        getattr(jax_presets, name)(species)


@pytest.mark.parametrize('species', [['Na', 'Cl'], ['O', 'Hf', 'O']])
def test_species_helpers_equal_jax(species):
    assert util.chemical_species_preprocess(species) == \
        jax_util.chemical_species_preprocess(species)
    assert util.get_type_mapper_from_specie(species) == \
        jax_util.get_type_mapper_from_specie(species)


def _conv_signature(tp, weight_nn, si2):
    return (repr(tp.irreps_in1), repr(tp.irreps_in2), repr(tp.irreps_out),
            tuple(weight_nn.hs), weight_nn.act, repr(si2.irreps_in),
            repr(si2.irreps_out), tuple(si2.paths))


@pytest.mark.parametrize('name', PRESETS)
def test_presets_build_the_same_layers(name):
    cfg = getattr(presets, name)(['Na', 'Cl'])
    port = [_conv_signature(lay.tp, lay.weight_nn, lay.si2)
            for lay in build_e3_equivariant_model(cfg).layers.values()
            if isinstance(lay, IrrepsConvolution)]
    ref = [_conv_signature(lay.tp, lay.weight_nn, lay.si2)
           for _, lay in jax_build(getattr(jax_presets, name)(['Na', 'Cl']))
           .layers if isinstance(lay, JL.IrrepsConvolution)]
    assert len(port) == 5 and port == ref


def test_mid_layer_is_the_third_convolution():
    conv = bench_pieces.mid_layer_conv()
    assert (conv.d1, conv.f, conv.nb, conv.w_numel, conv.d_out) == \
        (480, 9, 8, 960, 576)
    assert repr(conv.tp.irreps_in1) == '128x0e+64x1e+32x2e'


def test_library_path_follows_included_headers(tmp_path, monkeypatch):
    csrc = tmp_path / 'csrc'
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, 'CSRC_DIR', str(csrc))
    before = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    with open(csrc / 'fused_conv_body.cuh', 'a') as fh:
        fh.write('// edited\n')
    after = {n: cuda_build.library_path(n) for n in cuda_build.SOURCES}
    changed = {n for n in before if before[n] != after[n]}
    assert changed == set(cuda_build.SOURCES)
    with open(csrc / 'bench_dot.cu', 'a') as fh:
        fh.write('// edited\n')
    assert cuda_build.library_path('bench_dot') != after['bench_dot']


def test_every_micro_benchmark_kernel_has_a_counter():
    names = (list(bench_pieces.COUNTER.values())
             + list(bench_cgmxu.COUNTER.values())
             + list(bench_dot.COUNTER.values())
             + list(bench_cg.COUNTER.values())
             + list(bench_layout.COUNTER.values())
             + list(bench_tile.COUNTER.values()))
    assert sorted(names) == sorted(cuda_build.BENCH_KERNELS)
    assert set(names) <= set(cuda_build.launch_counts)
    for name in ('bench_pieces', 'bench_cgmxu', 'bench_dot', 'bench_cg',
                 'bench_layout', 'bench_tile'):
        assert os.path.exists(cuda_build.source_path(name))


@pytest.mark.parametrize('tool', [bench_pieces, bench_cgmxu, bench_dot,
                                  bench_cg, bench_layout, bench_tile],
                         ids=['pieces', 'cgmxu', 'dot', 'cg', 'layout',
                              'tile'])
def test_tools_exit_nonzero_without_a_card(tool, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert tool.main([]) != 0
    out = capsys.readouterr()
    assert 'needs an NVIDIA GPU' in out.err and out.out == ''
