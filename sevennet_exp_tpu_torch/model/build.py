"""Declarative model assembly.

Counterpart of ``sevennet_exp_tpu/model/build.py`` (reference
sevenn/model_build.py:384-576) for the NequIP-type networks of the
7net-0 family: the same layer names, irreps and parameter shapes, so a
JAX parameter pytree maps onto the port's buffers one to one.

edge_embedding -> onehot_idx_to_onehot -> onehot_to_feature_x ->
[T x (self_connection_intro | self_interaction_1 -> convolution (with
self_interaction_2 fused in) | self_connection_outro -> equivariant_gate)]
-> reduce_input_to_hidden -> reduce_hidden_to_energy ->
rescale_atomic_energy -> reduce_total_enegy.

Not in this port yet (the build raises): multi_cutoff, modalities and
the FCN readout.
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


def init_edge_embedding(config) -> L.EdgeEmbedding:
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
        raise NotImplementedError('multi_cutoff is not in the port yet')
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

    if config.get(KEY.USE_MODALITY, False):
        raise NotImplementedError('modalities are not in the port yet')
    train = bool(config.get(KEY.TRAIN_SHIFT_SCALE, False))
    if isinstance(shift, float) and isinstance(scale, float):
        return L.Rescale(shift=shift, scale=scale, train_shift_scale=train)
    return L.SpeciesWiseRescale(shift=_as_list(shift), scale=_as_list(scale),
                                train_shift_scale=train)


def nequip_interaction_block(
    t: int, irreps_x: Irreps, irreps_filter: Irreps, irreps_out_tp: Irreps,
    irreps_out: Irreps, weight_nn_layers: List[int], conv_denominator: float,
    self_connection_type: str, act_scalar: Dict[int, str],
    act_gate: Dict[int, str], act_radial: str, bias_in_linear: bool,
    num_species: int, geom: Optional[GeomSpec] = None,
    train_denominator: bool = False,
) -> List[Tuple[str, Any]]:
    """One NequIP block (reference sevenn/nn/interaction_blocks.py)."""
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
        LinearSpec(irreps_x, irreps_x, biases=bias_in_linear),
        key_in=KEY.NODE_FEATURE)))
    tp_spec = UVUTensorProductSpec(irreps_x, irreps_filter, irreps_out_tp)
    weight_nn = FullyConnectedNetSpec(
        hs=tuple(weight_nn_layers + [tp_spec.weight_numel]), act=act_radial)
    si2_spec = LinearSpec(tp_spec.irreps_out, irreps_for_gate_in,
                          biases=bias_in_linear)
    block.append((f'{t}_convolution', L.IrrepsConvolution(
        tp=tp_spec, weight_nn=weight_nn, si2=si2_spec,
        denominator=conv_denominator, geom=geom,
        train_denominator=train_denominator)))
    block.append((f'{t}_self_connection_outro', L.SelfConnectionOutro()))
    block.append((f'{t}_equivariant_gate', L.EquivariantGate(gate_spec)))
    return block


def build_e3_equivariant_model(config: Dict[str, Any]) -> SevenNetModel:
    """Reference model_build.py:384-576; the model's buffers start at
    zero until ``load_state`` fills them."""
    cfg = dict(_const.model_defaults(config))
    cfg.update(config)
    config = cfg
    if config.get(KEY.USE_MODALITY, False):
        raise NotImplementedError('modalities are not in the port yet')
    if config.get(KEY.READOUT_AS_FCN, False):
        raise NotImplementedError('the FCN readout is not in the port yet')

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
    layers.append(('edge_embedding', edge_embedding))
    # geometry-fused convs (ops/fused_conv.GeomSpec): Bessel, cutoff and SH
    # computed inside the conv kernels. Single-cutoff embedding with
    # normalised SH only, up to the kernels' lmax of 3.
    geom_spec = None
    if edge_embedding.normalize_sph and edge_embedding.lmax_edge <= 3:
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
    layers.append(('onehot_to_feature_x', L.IrrepsLinear(
        LinearSpec(Irreps(f'{num_species}x0e'), irreps_x, biases=use_bias),
        key_in=KEY.NODE_FEATURE)))
    weight_nn_layers = [edge_embedding.basis.num_basis] + list(
        config[KEY.CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS])

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
        ))
        irreps_x = irreps_out

    hidden_irreps = Irreps([(irreps_x.dim // 2, Irrep(0, 1))])
    layers.append(('reduce_input_to_hidden', L.IrrepsLinear(
        LinearSpec(irreps_x, hidden_irreps, biases=use_bias),
        key_in=KEY.NODE_FEATURE)))
    layers.append(('reduce_hidden_to_energy', L.IrrepsLinear(
        LinearSpec(hidden_irreps, Irreps([(1, Irrep(0, 1))]),
                   biases=use_bias),
        key_in=KEY.NODE_FEATURE, key_out=KEY.SCALED_ATOMIC_ENERGY)))
    layers.append(('rescale_atomic_energy', init_shift_scale(config)))
    layers.append(('reduce_total_enegy', L.AtomReduce()))
    return SevenNetModel(layers=layers, config=config,
                         type_map=dict(config[KEY.TYPE_MAP]),
                         cutoff=config[KEY.CUTOFF])
