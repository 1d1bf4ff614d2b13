"""The ``bench_pieces`` variants' plain versions against the JAX package.

On the 7net-0 mid layer at full width (``sevennet_0_config(species=['Na',
'Cl'])``, third convolution; d1 = 480, 960 radial weights, 576 outputs),
two atoms of D = 32 rows, numpy inputs and weights:

- ``full`` is ``FusedConv.plain_forward`` and equals the JAX XLA conv chain
  (``IrrepsConvolution._rows_to_nodes`` with the Pallas kernels off:
  MLP -> TP -> sum over the D rows -> si2) within 1e-4 relative;
- each stripped variant equals its stand-in as ``tools/bench_pieces.py``
  defines it (``:100-155``), written here in jnp on the JAX layer's specs
  (its aggregate read as the XLA chain's si2 reads it, ROADMAP C);
- the kernels' own arithmetic for each variant -- the forward template of
  ``csrc/fused_conv_geom.cu`` with the ``bench_pieces`` build's stub mask,
  replayed in numpy in its loop order from ``FusedConv.kernel_tables``
  (``tests/test_torch_geom_plan.py::_Replay``: the dense forward with the
  stand-in of one piece, and for ``-agg`` the edge forward) -- equals the
  plain version, with ``ms = 1`` and with a fifth of the rows pads, so the
  stand-ins of the CUDA kernels and of the plain versions cannot drift
  apart unseen;
- the ``bench_pieces`` library is that source built with
  ``-DFUSED_CONV_PIECES=1``: everything of it sits behind the gate, so the
  other builds of the source never see it, and its variants' ``MODE``s are
  the template's.

The CUDA kernels are held against the plain versions on the card
(tests/test_torch_cuda.py; chip_smoke.py, where ``full`` is kernel 1 and
``-agg`` the edge-row kernel 1 by their SASS digests).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sevennet_exp_tpu.model import layers as JL
from sevennet_exp_tpu.model.build import build_e3_equivariant_model
from sevennet_exp_tpu.ops import pallas_conv
from sevennet_exp_tpu.presets import sevennet_0_config
from sevennet_exp_tpu_torch.ops import cuda_build
from sevennet_exp_tpu_torch.ops import fused_conv as pfc
from sevennet_exp_tpu_torch.tools import bench_pieces as bp
from test_torch_geom_plan import _Replay

torch.set_num_threads(2)
D, N_ATOMS = 32, 2
REL = 1e-4


@pytest.fixture(scope='module')
def jax_mid_conv():
    model = build_e3_equivariant_model(sevennet_0_config(species=['Na',
                                                                  'Cl']))
    return [lay for _, lay in model.layers
            if isinstance(lay, JL.IrrepsConvolution)][2]


@pytest.fixture(scope='module')
def conv():
    return bp.mid_layer_conv()


@pytest.fixture(scope='module')
def inputs(conv):
    rng = np.random.default_rng(5)
    rows = N_ATOMS * D
    arrs = [rng.normal(size=(rows, conv.d1)), rng.normal(size=(rows, conv.f)),
            rng.normal(size=(rows, conv.nb)), np.ones((rows, 1))]
    hs = conv.mlp.hs
    mlp = [rng.normal(size=(hs[i], hs[i + 1])) for i in range(3)]
    si2 = [rng.normal(size=(mi, mo)) for (_, _, mi, mo, _) in conv.si2.paths]
    f32 = [np.asarray(a, np.float32) for a in arrs + mlp + si2]
    return f32[:4], f32[4:7], f32[7:]


def _port(conv, variant, inputs):
    (xg, sh, emb, ms), mlp, si2 = inputs
    t = [torch.tensor(a) for a in (xg, sh, emb, ms)]
    return bp.variant_forward(conv, variant, *t,
                              tuple(torch.tensor(w) for w in mlp),
                              tuple(torch.tensor(w) for w in si2)).numpy()


def _jax_stand_in(layer, variant, inputs):
    """The JAX tool's stand-ins on the XLA chain of the JAX layer."""
    (xg, sh, emb, ms), mlp, si2 = (
        [jnp.asarray(a) for a in inputs[0]],
        {f'w{i}': jnp.asarray(w) for i, w in enumerate(inputs[1])},
        {f'w{n}': jnp.asarray(w) for n, w in enumerate(inputs[2])})
    tp, wn = layer.tp, layer.weight_nn.hs[-1]
    if variant == '-mlp':
        w = jnp.broadcast_to(emb[:, 0:1], (xg.shape[0], wn)) * ms
    elif variant == '-w':
        w = jnp.ones((xg.shape[0], wn), jnp.float32)
    else:
        w = layer.weight_nn.apply(mlp, emb) * ms
    if variant == '-cg':
        plan, _ = pallas_conv._tp_plan(tp)
        blocks = [None] * len(tp.irreps_out)
        for p in plan:
            x0 = xg[:, p['x_off']:p['x_off'] + p['mul']]
            wr = w[:, p['w_off']:p['w_off'] + p['mul']]
            blocks[p['k']] = jnp.concatenate([x0 * wr] * p['dim3'], axis=1)
        message = jnp.concatenate(blocks, axis=1)
    else:
        message = tp.apply(xg, sh, w)
    if variant == '-agg':
        return np.asarray(layer.si2.apply(si2, message, skip_bias=True))
    agg = message.reshape((-1, D) + message.shape[1:]).sum(1)
    if variant != '-si2':
        return np.asarray(layer.si2.apply(si2, agg, skip_bias=True))
    groups, d_out = pallas_conv._si2_groups(tp, layer.si2)
    in_slices = layer.si2.irreps_in.slices()
    out = np.zeros((agg.shape[0], d_out), np.float32)
    for g in groups:
        K, mo, d3 = g['K'], g['mo'], g['dim3']
        a = np.asarray(agg[:, in_slices[layer.si2.paths[g['path']][0]]]
                       ).reshape(-1, d3, K)[:, :, :min(K, mo)]
        blk = np.zeros((agg.shape[0], d3, mo), np.float32)
        blk[:, :, :a.shape[2]] = a
        out[:, g['out_off']:g['out_off'] + d3 * mo] = blk.reshape(
            agg.shape[0], -1)
    return out


def _close(got, ref):
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=REL * float(np.abs(ref).max()))


def test_full_is_plain_forward_and_the_jax_xla_chain(conv, jax_mid_conv,
                                                     inputs):
    got = _port(conv, 'full', inputs)
    (xg, sh, emb, ms), mlp, si2 = inputs
    ref = conv.plain_forward(*(torch.tensor(a) for a in (xg, sh, emb, ms)),
                             tuple(torch.tensor(w) for w in mlp),
                             tuple(torch.tensor(w) for w in si2)).numpy()
    np.testing.assert_array_equal(got, ref)
    _close(got, _jax_stand_in(jax_mid_conv, 'full', inputs))


@pytest.mark.parametrize('variant', bp.VARIANTS[1:])
def test_stripped_variants_match_jax_stand_ins(conv, jax_mid_conv, inputs,
                                               variant):
    got = _port(conv, variant, inputs)
    _close(got, _jax_stand_in(jax_mid_conv, variant, inputs))
    # a stand-in changes the result: the variant is not the full kernel
    full = _port(conv, 'full', inputs)
    assert got.shape != full.shape or \
        float(np.abs(got - full).max()) > REL * float(np.abs(full).max())


def _replay(conv, variant, xg, sh, emb, ms, mlp_ws, si2_ws):
    """The variant's kernel in numpy, in the forward template's loop order:
    the dense forward (kernel 1) with the variant's stand-in, or for -agg
    the edge forward on the rows as the edge list."""
    rep = _Replay(conv, D, mlp_ws, si2_ws, geom=False)
    xg, sh, emb, ms = (a.numpy() for a in (xg, sh, emb, ms))
    if variant == '-agg':
        return rep.forward_edge(xg, emb, sh, ms)
    return rep.forward_rows(xg, emb, sh, ms,
                            skip=None if variant == 'full' else variant[1:])


@pytest.mark.parametrize('pads', [False, True], ids=['ms1', 'pads'])
@pytest.mark.parametrize('variant', bp.VARIANTS)
def test_kernel_tables_reproduce_each_variant(conv, inputs, variant, pads):
    (xg, sh, emb, ms), mlp, si2 = inputs
    if pads:
        ms = ms.copy()
        ms[np.random.default_rng(7).uniform(size=ms.shape[0]) < 0.2] = 0.0
        assert (ms == 0).any()
    args = [torch.tensor(a) for a in (xg, sh, emb, ms)] + [
        tuple(torch.tensor(w) for w in mlp),
        tuple(torch.tensor(w) for w in si2)]
    _close(_replay(conv, variant, *args),
           bp.plain_variant(conv, variant, *args).numpy())


# -- the build: csrc/fused_conv_geom.cu with -DFUSED_CONV_PIECES=1 ------------

_DIRECTIVE = re.compile(r'^\s*#\s*(if|ifdef|ifndef|elif|else|endif|define)\b'
                        r'\s*(.*)$')


def _active(text, defines):
    """The lines of ``text`` the C preprocessor keeps under the -D macros
    ``defines`` ({name: int}): the file's #if / #ifdef / #ifndef / #else /
    #endif on its macros (!, &&, ||), each #define of an int seen while
    active; the conditional directives and the // comments dropped."""
    macros, stack, out = dict(defines), [], []
    on = True

    def value(cond):
        expr = re.sub(r'\b[A-Za-z_]\w*\b',
                      lambda m: str(int(macros.get(m.group(0), 0))), cond)
        expr = (expr.replace('&&', ' and ').replace('||', ' or ')
                .replace('!', ' not '))
        return bool(eval(expr))

    for line in text.splitlines():
        m = _DIRECTIVE.match(line)
        kind, arg = (m.group(1), m.group(2).split('//')[0].strip()) if m \
            else (None, '')
        if kind in ('if', 'ifdef', 'ifndef'):
            cond = (value(arg) if kind == 'if' else
                    (arg in macros) == (kind == 'ifdef'))
            stack.append((on, cond))
            on = on and cond
        elif kind == 'elif':
            raise AssertionError('#elif: not handled here')
        elif kind == 'else':
            parent, cond = stack[-1]
            stack[-1] = (parent, not cond)
            on = parent and not cond
        elif kind == 'endif':
            on = stack.pop()[0]
        elif on:
            if kind == 'define':
                name, _, val = arg.partition(' ')
                if re.fullmatch(r'\d+', val.strip()):
                    macros[name] = int(val)
            out.append(line.split('//')[0])
    assert not stack
    return '\n'.join(out)


# what only the bench_pieces build may compile
PIECES_ONLY = {'S_MLP', 'S_CG', 'S_W', 'S_SI2', 'with_piece', 'piece_plan',
               'bench_pieces_fwd', 'bench_pieces_resources'}


@pytest.mark.parametrize('build', ['fused_conv_geom', 'fused_conv_geom_ssp',
                                   'fused_conv_geom_extw', 'bench_pieces'])
def test_pieces_gate_is_invisible_to_the_other_builds(build):
    """The stub mask, its branches and the bench_pieces entries sit behind
    FUSED_CONV_PIECES: the default, ssp and extw builds see none of them
    (so they compile the text they did before), and the bench_pieces build
    compiles its two C entries and no other."""
    with open(cuda_build.source_path('fused_conv_geom')) as fh:
        text = _active(fh.read(), {
            d[2:].split('=')[0]: int(d.split('=')[1])
            for d in cuda_build.DEFINES.get(build, ())})
    words = set(re.findall(r'\w+', text))
    entries = set(re.findall(r'extern "C" int (\w+)\(', text))
    if build == 'bench_pieces':
        assert PIECES_ONLY <= words
        assert entries == {'bench_pieces_fwd', 'bench_pieces_resources'}
        assert re.search(r'#define PIECES_ARG , MODE$', text, re.M)
    else:
        assert not PIECES_ONLY & words
        assert not any(e.startswith('bench_pieces') for e in entries)
        assert re.search(r'#define PIECES_ARG$', text, re.M)
    if build == 'fused_conv_geom':
        assert {'fused_conv_fwd', 'fused_conv_edge_fwd'} <= entries


def test_variant_modes_are_the_templates():
    """VARIANTS[i] launches the forward template's instance MODES[v]: the
    C entry's switch and the stub mask against the tool's mirror."""
    with open(cuda_build.source_path('fused_conv_geom')) as fh:
        src = fh.read()
    consts = {k: int(v) for k, v in re.findall(
        r'\b(K_DENSE|K_GEOM|K_EDGE|S_MLP|S_CG|S_W|S_SI2) = (\d+)', src)}
    cases = re.findall(r'case (\d): return f\(Ix<([\w |]+)>\(\)\);', src)
    assert [int(i) for i, _ in cases] == list(range(len(bp.VARIANTS)))
    for i, expr in cases:
        mode = 0
        for name in expr.split('|'):
            mode |= consts[name.strip()]
        assert bp.MODES[bp.VARIANTS[int(i)]] == mode
    names = {f'_ZN12fused_conv_geom_fwd_kernelILi{m}EEvPKf': v
             for v, m in bp.MODES.items()}
    assert {bp.variant_of(k): v for k, v in names.items()} == {
        v: v for v in bp.VARIANTS}
    assert bp.variant_of('fused_conv_geom_bwd_kernelILi9ELi0EEv') is None


def test_variant_costs(conv, inputs):
    ms = torch.tensor(inputs[0][3])
    full_f, full_b = bp.variant_cost(conv, ms, 'full')
    assert (full_f, full_b) == (pfc.conv_cost(conv, ms)[0],
                                pfc.conv_bytes(conv, ms)[0])
    for variant in bp.VARIANTS[1:]:
        f, b = bp.variant_cost(conv, ms, variant)
        assert (f > full_f) == (variant == '-agg') and 0 < f
        assert b <= full_b or variant == '-agg'
