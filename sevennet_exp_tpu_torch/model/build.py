"""Declarative model assembly.

Counterpart of ``sevennet_exp_tpu/model/build.py`` (reference
sevenn/model_build.py:384-576) for the NequIP-type networks of the
7net-0 family: the same layer names, irreps and parameter shapes, so a
JAX parameter pytree maps onto the port's buffers one to one.

edge_embedding -> onehot_idx_to_onehot [-> one_hot_modality] ->
onehot_to_feature_x -> [T x (self_connection_intro | self_interaction_1 ->
convolution (with self_interaction_2 fused in, or followed by a separate
modal self_interaction_2) | self_connection_outro -> equivariant_gate)]
-> reduce_input_to_hidden -> reduce_hidden_to_energy (or readout_FCN) ->
rescale_atomic_energy -> reduce_total_enegy.

The family's other forms: per-layer cutoffs (``multi_cutoff``: a
``MultiCutoffEdgeEmbedding``, each convolution on its cutoff's embedding
and mask, never geometry-fused), modalities (``use_modality``: the modal
one-hot appended to the linears the ``use_modal_*`` flags name, and a
``ModalWiseRescale``) and the FCN readout (``readout_as_fcn``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .. import _const
from .. import _keys as KEY
from ..irreps import Irrep, Irreps, infer_irreps_out
from ..ops.fused_conv import GeomSpec
from ..ops.radial import BesselBasis, PolynomialCutoff, XPLORCutoff
from ..ops.tensor_product import (
    FullyConnectedNetSpec,
    FullyConnectedTPSpec,
    GateSpec,
    LinearSpec,
    UVUTensorProductSpec,
)
from . import layers as L
from .model import SevenNetModel


def init_edge_embedding(config):
    cutoff = config[KEY.CUTOFF]
    env_cfg = dict(config[KEY.CUTOFF_FUNCTION])
    env_name = env_cfg.pop(KEY.CUTOFF_FUNCTION_NAME)
    if env_name == 'poly_cut':
        env = PolynomialCutoff(cutoff=cutoff,
                               p=env_cfg.get(KEY.POLY_CUT_P, 6))
    elif env_name == 'XPLOR':
        env = XPLORCutoff(cutoff=cutoff, cutoff_on=env_cfg['cutoff_on'])
    else:
        raise ValueError(f'unknown cutoff function {env_name}')
    rbf_cfg = dict(config[KEY.RADIAL_BASIS])
    rbf_name = rbf_cfg.pop(KEY.RADIAL_BASIS_NAME)
    if rbf_name != 'bessel':
        raise ValueError(f'unknown radial basis {rbf_name}')
    basis = BesselBasis(
        cutoff=cutoff,
        num_basis=rbf_cfg.get(KEY.BESSEL_BASIS_NUM, 8),
        trainable=rbf_cfg.get('trainable_coeff', True),
    )
    lmax_edge = config[KEY.LMAX]
    if config.get(KEY.LMAX_EDGE, -1) > 0:
        lmax_edge = config[KEY.LMAX_EDGE]
    parity = -1 if config[KEY.IS_PARITY] else 1
    if config.get(KEY.MULTI_CUTOFF):
        # per-layer cutoff radii (reference model_build.py:87-103): one
        # static edge list at the global cutoff, a mask per cutoff
        cutoffs = sorted(set(float(c) for c in config[KEY.MULTI_CUTOFF]))
        if cutoffs[-1] > float(cutoff) + 1e-9:
            raise ValueError(
                f'multi_cutoff {cutoffs[-1]} exceeds cutoff {cutoff}; '
                f'set cutoff to the largest per-layer value')
        bases, envs = [], []
        for c in cutoffs:
            bases.append(BesselBasis(
                cutoff=c, num_basis=rbf_cfg.get(KEY.BESSEL_BASIS_NUM, 8),
                trainable=rbf_cfg.get('trainable_coeff', True)))
            if env_name == 'XPLOR':
                # the reference sets r_on = cutoff - 1 per sub-cutoff
                envs.append(XPLORCutoff(cutoff=c, cutoff_on=c - 1.0))
            else:
                envs.append(PolynomialCutoff(
                    cutoff=c, p=env_cfg.get(KEY.POLY_CUT_P, 6)))
        return L.MultiCutoffEdgeEmbedding(
            bases=bases, cutoff_fns=envs, lmax_edge=lmax_edge,
            parity=parity,
            normalize_sph=config.get(KEY._NORMALIZE_SPH, True))
    return L.EdgeEmbedding(basis=basis, cutoff_fn=env, lmax_edge=lmax_edge,
                           parity=parity,
                           normalize_sph=config.get(KEY._NORMALIZE_SPH, True))


def init_shift_scale(config):
    shift, scale = config[KEY.SHIFT], config[KEY.SCALE]
    type_map = config[KEY.TYPE_MAP]
    n_types = len(type_map)

    def _as_list(s):
        if hasattr(s, 'tolist'):
            s = s.tolist()
        if isinstance(s, (int, float)):
            return [float(s)] * n_types
        if isinstance(s, list):
            if len(s) == 1:
                return [float(s[0])] * n_types
            if len(s) == n_types:
                return [float(v) for v in s]
            if len(s) == _const.NUM_UNIV_ELEMENT:
                return [float(s[z])
                        for z in sorted(type_map, key=lambda x: type_map[x])]
            raise ValueError(f'bad shift/scale length {len(s)}')
        raise ValueError(f'bad shift/scale {s!r}')

    train = bool(config.get(KEY.TRAIN_SHIFT_SCALE, False))
    modal_shift = config.get(KEY.USE_MODAL_WISE_SHIFT, False)
    modal_scale = config.get(KEY.USE_MODAL_WISE_SCALE, False)
    if config.get(KEY.USE_MODALITY, False) and (modal_shift or modal_scale):
        modal_map = config[KEY.MODAL_MAP]
        n_modal = len(modal_map)

        def _modal(s, use_mw):
            if isinstance(s, dict):
                s = [s[k] for k in sorted(s, key=lambda x: modal_map[x])]
            if hasattr(s, 'tolist'):
                s = s.tolist()
            if not use_mw:
                return _as_list(s)
            if isinstance(s, (int, float)):
                return [[float(s)] * n_types for _ in range(n_modal)]
            if isinstance(s, list) and len(s) == n_modal and all(
                    isinstance(v, (int, float)) for v in s):
                return [[float(v)] * n_types for v in s]
            if isinstance(s, list):
                if all(isinstance(v, list) for v in s):
                    return [_as_list(v) for v in s]
                return [_as_list(s) for _ in range(n_modal)]
            raise ValueError(f'bad modal shift/scale {s!r}')

        return L.ModalWiseRescale(
            shift=_modal(shift, modal_shift),
            scale=_modal(scale, modal_scale),
            use_modal_wise_shift=modal_shift,
            use_modal_wise_scale=modal_scale, train_shift_scale=train)
    if isinstance(shift, float) and isinstance(scale, float):
        return L.Rescale(shift=shift, scale=scale, train_shift_scale=train)
    return L.SpeciesWiseRescale(shift=_as_list(shift), scale=_as_list(scale),
                                train_shift_scale=train)


def _with_modal(irreps: Irreps, n_modal: int) -> Irreps:
    """A linear's input with the modal one-hot appended (n > 1)."""
    return irreps + Irreps(f'{n_modal}x0e') if n_modal > 1 else irreps


def nequip_interaction_block(
    t: int, irreps_x: Irreps, irreps_filter: Irreps, irreps_out_tp: Irreps,
    irreps_out: Irreps, weight_nn_layers: List[int], conv_denominator: float,
    self_connection_type: str, act_scalar: Dict[int, str],
    act_gate: Dict[int, str], act_radial: str, bias_in_linear: bool,
    num_species: int, geom: Optional[GeomSpec] = None,
    train_denominator: bool = False,
    si1_modal: int = 0, si2_modal: int = 0,
    key_weight_input: str = KEY.EDGE_EMBEDDING,
    key_mask: str = KEY.EDGE_MASK,
) -> List[Tuple[str, Any]]:
    """One NequIP block (reference sevenn/nn/interaction_blocks.py).
    key_weight_input / key_mask: the layer's cutoff under multi_cutoff.
    si1_modal / si2_modal: modalities whose one-hot self_interaction_1 /
    self_interaction_2 take (0: none); with the modal self_interaction_2
    the convolution has no si2 and a node-level linear follows it."""
    block: List[Tuple[str, Any]] = []
    gate_spec = GateSpec(irreps_out, act_scalar, act_gate)
    irreps_for_gate_in = gate_spec.irreps_in
    if self_connection_type == 'nequip':
        block.append((f'{t}_self_connection_intro', L.SelfConnectionIntro(
            FullyConnectedTPSpec(irreps_x, Irreps(f'{num_species}x0e'),
                                 irreps_for_gate_in))))
    elif self_connection_type == 'linear':
        block.append((f'{t}_self_connection_intro',
                      L.SelfConnectionLinearIntro(LinearSpec(
                          irreps_x, irreps_for_gate_in,
                          biases=bias_in_linear))))
    else:
        raise ValueError(self_connection_type)
    block.append((f'{t}_self_interaction_1', L.IrrepsLinear(
        LinearSpec(_with_modal(irreps_x, si1_modal), irreps_x,
                   biases=bias_in_linear),
        key_in=KEY.NODE_FEATURE, num_modalities=si1_modal)))
    tp_spec = UVUTensorProductSpec(irreps_x, irreps_filter, irreps_out_tp)
    weight_nn = FullyConnectedNetSpec(
        hs=tuple(weight_nn_layers + [tp_spec.weight_numel]), act=act_radial)
    conv_kw = dict(tp=tp_spec, weight_nn=weight_nn,
                   denominator=conv_denominator,
                   train_denominator=train_denominator,
                   key_weight_input=key_weight_input, key_mask=key_mask)
    if si2_modal > 1:
        # the modal one-hot is per atom: self_interaction_2 stays a node
        # level linear, and the convolution has no si2 to fuse
        block.append((f'{t}_convolution',
                      L.IrrepsConvolution(si2=None, **conv_kw)))
        block.append((f'{t}_self_interaction_2', L.IrrepsLinear(
            LinearSpec(_with_modal(tp_spec.irreps_out, si2_modal),
                       irreps_for_gate_in, biases=bias_in_linear),
            key_in=KEY.NODE_FEATURE, num_modalities=si2_modal)))
    else:
        si2_spec = LinearSpec(tp_spec.irreps_out, irreps_for_gate_in,
                              biases=bias_in_linear)
        block.append((f'{t}_convolution', L.IrrepsConvolution(
            si2=si2_spec, geom=geom, **conv_kw)))
    block.append((f'{t}_self_connection_outro', L.SelfConnectionOutro()))
    block.append((f'{t}_equivariant_gate', L.EquivariantGate(gate_spec)))
    return block


def build_e3_equivariant_model(config: Dict[str, Any]) -> SevenNetModel:
    """Reference model_build.py:384-576; the model's buffers start at
    zero until ``load_state`` fills them."""
    cfg = dict(_const.model_defaults(config))
    cfg.update(config)
    config = cfg
    use_modality = bool(config.get(KEY.USE_MODALITY, False))
    num_modalities = config.get(KEY.NUM_MODALITIES, 0)

    def modal_n(flag):
        return num_modalities if use_modality and config.get(flag) else 0

    layers: List[Tuple[str, Any]] = []
    num_species = config[KEY.NUM_SPECIES]
    feature_multiplicity = config[KEY.NODE_FEATURE_MULTIPLICITY]
    num_conv = config[KEY.NUM_CONVOLUTION]
    use_bias = config[KEY.USE_BIAS_IN_LINEAR]
    lmax_node = config[KEY.LMAX]
    if config.get(KEY.LMAX_NODE, -1) > 0:
        lmax_node = config[KEY.LMAX_NODE]
    p_map = {'e': 1, 'o': -1}
    act_scalar = {p_map[k]: v
                  for k, v in config[KEY.ACTIVATION_SCARLAR].items()}
    act_gate = {p_map[k]: v for k, v in config[KEY.ACTIVATION_GATE].items()}

    irreps_manual = None
    if config.get(KEY.IRREPS_MANUAL, False) is not False:
        irreps_manual = [Irreps(i) for i in config[KEY.IRREPS_MANUAL]]
        assert len(irreps_manual) == num_conv + 1, 'invalid irreps_manual'
    conv_denominator = config[KEY.CONV_DENOMINATOR]
    if not isinstance(conv_denominator, list):
        conv_denominator = [conv_denominator] * num_conv

    edge_embedding = init_edge_embedding(config)
    irreps_filter = edge_embedding.irreps_out
    multi = isinstance(edge_embedding, L.MultiCutoffEdgeEmbedding)
    num_basis = (edge_embedding.bases[0] if multi
                 else edge_embedding.basis).num_basis
    layers.append(('edge_embedding', edge_embedding))
    # geometry-fused convs (ops/fused_conv.GeomSpec): Bessel, cutoff and SH
    # computed inside the conv kernels. Single-cutoff embedding with
    # normalised SH only, up to the kernels' lmax of 3; multi-cutoff
    # layers keep the edge pipeline (JAX build.py:326-331).
    geom_spec = None
    if (not multi and edge_embedding.normalize_sph
            and edge_embedding.lmax_edge <= 3):
        env = edge_embedding.cutoff_fn
        geom_spec = GeomSpec(
            cutoff=float(edge_embedding.basis.cutoff),
            num_basis=int(edge_embedding.basis.num_basis),
            lmax=int(edge_embedding.lmax_edge),
            cutoff_kind='xplor' if isinstance(env, XPLORCutoff) else 'poly',
            cutoff_p=float(getattr(env, 'p', 6)),
            cutoff_on=float(getattr(env, 'cutoff_on', 0.0)))
    irreps_x = (Irreps(f'{feature_multiplicity}x0e')
                if irreps_manual is None else irreps_manual[0])
    layers.append(('onehot_idx_to_onehot',
                   L.OnehotEmbedding(num_classes=num_species)))
    if use_modality:
        layers.append(('one_hot_modality', L.OnehotEmbedding(
            num_classes=num_modalities, key_x=KEY.MODAL_TYPE,
            key_out=KEY.MODAL_ATTR, key_save=None, key_additional=None)))
    ne_modal = modal_n(KEY.USE_MODAL_NODE_EMBEDDING)
    layers.append(('onehot_to_feature_x', L.IrrepsLinear(
        LinearSpec(_with_modal(Irreps(f'{num_species}x0e'), ne_modal),
                   irreps_x, biases=use_bias),
        key_in=KEY.NODE_FEATURE, num_modalities=ne_modal)))
    weight_nn_layers = [num_basis] + list(
        config[KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS])
    multi_cutoff = config.get(KEY.MULTI_CUTOFF)

    for t in range(num_conv):
        parity_mode = 'full'
        lmax_t = lmax_node
        if t == num_conv - 1:
            lmax_t = 0
            parity_mode = 'even'
        irreps_out = (
            infer_irreps_out(irreps_x, irreps_filter, lmax_t, parity_mode,
                             fix_multiplicity=feature_multiplicity)
            if irreps_manual is None else irreps_manual[t + 1])
        irreps_out_tp = infer_irreps_out(irreps_x, irreps_filter,
                                         irreps_out.lmax, parity_mode, False)
        layers.extend(nequip_interaction_block(
            t=t, irreps_x=irreps_x, irreps_filter=irreps_filter,
            irreps_out_tp=irreps_out_tp, irreps_out=irreps_out,
            weight_nn_layers=weight_nn_layers,
            conv_denominator=conv_denominator[t],
            self_connection_type=config[KEY.SELF_CONNECTION_TYPE],
            act_scalar=act_scalar, act_gate=act_gate,
            act_radial=config[KEY.ACTIVATION_RADIAL],
            bias_in_linear=use_bias, num_species=num_species,
            geom=geom_spec,
            train_denominator=bool(config[KEY.TRAIN_DENOMINTAOR]),
            si1_modal=modal_n(KEY.USE_MODAL_SELF_INTER_INTRO),
            si2_modal=modal_n(KEY.USE_MODAL_SELF_INTER_OUTRO),
            key_weight_input=(KEY.EDGE_EMBEDDING + str(float(multi_cutoff[t]))
                              if multi_cutoff else KEY.EDGE_EMBEDDING),
            key_mask=(KEY.EDGE_MASK + str(float(multi_cutoff[t]))
                      if multi_cutoff else KEY.EDGE_MASK),
        ))
        irreps_x = irreps_out

    if not config.get(KEY.READOUT_AS_FCN, False):
        hidden_irreps = Irreps([(irreps_x.dim // 2, Irrep(0, 1))])
        ro_modal = modal_n(KEY.USE_MODAL_OUTPUT_BLOCK)
        layers.append(('reduce_input_to_hidden', L.IrrepsLinear(
            LinearSpec(_with_modal(irreps_x, ro_modal), hidden_irreps,
                       biases=use_bias),
            key_in=KEY.NODE_FEATURE, num_modalities=ro_modal)))
        layers.append(('reduce_hidden_to_energy', L.IrrepsLinear(
            LinearSpec(hidden_irreps, Irreps([(1, Irrep(0, 1))]),
                       biases=use_bias),
            key_in=KEY.NODE_FEATURE, key_out=KEY.SCALED_ATOMIC_ENERGY)))
    else:
        layers.append(('readout_FCN', L.FCNReadout(FullyConnectedNetSpec(
            hs=tuple([irreps_x.dim]
                     + list(config[KEY.READOUT_FCN_HIDDEN_NEURONS]) + [1]),
            act=config[KEY.READOUT_FCN_ACTIVATION]))))
    layers.append(('rescale_atomic_energy', init_shift_scale(config)))
    layers.append(('reduce_total_enegy', L.AtomReduce()))
    return SevenNetModel(layers=layers, config=config,
                         type_map=dict(config[KEY.TYPE_MAP]),
                         cutoff=config[KEY.CUTOFF],
                         modal_map=dict(config.get(KEY.MODAL_MAP) or {}))
