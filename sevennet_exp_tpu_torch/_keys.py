"""Canonical tensor/config key registry.

Copy of ``sevennet_exp_tpu/_keys.py`` (same string names as the
reference sevenn/_keys.py:26-227), kept here so the PyTorch port imports
nothing of the JAX package.
"""

# -- data keys --------------------------------------------------------------
ATOMIC_NUMBERS = 'atomic_numbers'       # (N,)
POS = 'pos'                             # (N, 3)
CELL = 'cell_lattice_vectors'           # (G, 3, 3)
CELL_SHIFT = 'pbc_shift'                # (E, 3)
CELL_VOLUME = 'cell_volume'             # (G,)

EDGE_VEC = 'edge_vec'                   # (E, 3)
EDGE_LENGTH = 'edge_length'             # (E,)

EDGE_IDX = 'edge_index'                 # (2, E); [0]=center i, [1]=neighbor j
ATOM_TYPE = 'atom_type'                 # (N,) one-hot index
NODE_FEATURE = 'x'
NODE_FEATURE_GHOST = 'x_ghost'
NODE_ATTR = 'node_attr'
MODAL_ATTR = 'modal_attr'
MODAL_TYPE = 'modal_type'
EDGE_ATTR = 'edge_attr'
EDGE_EMBEDDING = 'edge_embedding'

ENERGY = 'total_energy'
FORCE = 'force_of_atoms'
STRESS = 'stress'

SCALED_ENERGY = 'scaled_total_energy'
SCALED_ATOMIC_ENERGY = 'scaled_atomic_energy'
ATOMIC_ENERGY = 'atomic_energy'
PRED_TOTAL_ENERGY = 'inferred_total_energy'
PRED_PER_ATOM_ENERGY = 'inferred_per_atom_energy'
PER_ATOM_ENERGY = 'per_atom_energy'
PRED_FORCE = 'inferred_force'
SCALED_FORCE = 'scaled_force'
PRED_STRESS = 'inferred_stress'
SCALED_STRESS = 'scaled_stress'

NUM_ATOMS = 'num_atoms'
NUM_GHOSTS = 'num_ghosts'
NLOCAL = 'nlocal'
USER_LABEL = 'user_label'
DATA_WEIGHT = 'data_weight'
DATA_MODALITY = 'data_modality'
BATCH = 'batch'
TAG = 'tag'

SELF_CONNECTION_TEMP = 'self_cont_tmp'
BATCH_SIZE = 'batch_size'
INFO = 'data_info'
LABEL_NONE = 'No_label'

# padding masks (TPU-native addition: static shapes require explicit masks)
NODE_MASK = 'node_mask'                 # (N,) 1.0 for real atoms
EDGE_MASK = 'edge_mask'                 # (E,)
EDGE_REV = 'edge_rev'                   # (E,) reverse-edge permutation
EDGE_HALF = 'edge_half'                 # (E//2,) representative edge per
#   undirected pair (sentinel E past the real count); half-list MLP
EDGE_PAIR = 'edge_pair'                 # (E,) pair id of each edge in
#   the half list (pad rows hold 0 -- masked to zero anyway)
#   (present only when the edge list is symmetric + dst-sorted; enables
#   sorted-scatter aggregation, see ops/scatter.py)
EDGE_DENSE_D = 'edge_dense_d'           # python int (in-trace static):
#   dense neighbor-grid layout — row i*D + k is atom i's k-th incident
#   edge; aggregation = reshape(N, D, F).sum(1), scatter-free
CONV_CHUNK_ROWS = 'conv_chunk_rows'     # python int (in-trace static):
#   memory-chunked convolution — scan over row chunks with remat so
#   O(E x d1) gathered features never materialize (100k-atom regime)
EDGE_PACK_G = 'edge_pack_g'             # python int (in-trace static):
#   group size of the packed edge-feature layout (ops/scatter.py
#   pack_cols) — narrow (E, W) arrays lane-pad W -> 128 on TPU, so at
#   scale the edge pipeline flows as 1-D columns + one packed array
EDGE_VEC_COLS = 'edge_vec_cols'         # (vx, vy, vz) 1-D (E,) tuple —
#   replaces EDGE_VEC in the packed large-system path
EDGE_FEAT_PACKED = 'edge_feat_packed'   # (E/G, (n_basis+n_sh)*G):
#   pack_cols([emb cols..., sh cols...], G); consumed chunk-wise by
#   IrrepsConvolution (unpack_cols)
EDGE_GEOM_PACKED = 'edge_geom_packed'   # python bool (in-trace static):
#   geometry-fused packed regime — EdgeEmbedding packs only the raw
#   edge-vector columns (EDGE_VEC_PACKED, 3 cols instead of
#   n_basis+n_sh); convolutions compute Bessel/cutoff/SH in-kernel
#   (ops/pallas_conv.GeomSpec). In this port nothing is packed: the flag
#   means the convolutions run geometry-fused from EDGE_VEC (chunked or
#   whole-array; the engine sets it) and EdgeEmbedding computes no
#   EDGE_EMBEDDING / EDGE_ATTR (ops/fused_conv.GeomSpec)
EDGE_VEC_PACKED = 'edge_vec_packed'     # (E/G, 3*G): pack_cols of
#   (vx, vy, vz) for the geometry-fused chunked path
EDGE_BESSEL_COEFFS = 'edge_bessel_coeffs'  # (n_basis,) Bessel
#   frequencies, stashed by EdgeEmbedding for geometry-fused convs
GRAPH_MASK = 'graph_mask'               # (G,)

# -- train / data configuration keys ---------------------------------------
PREPROCESS_NUM_CORES = 'preprocess_num_cores'
SAVE_DATASET = 'save_dataset_path'
SAVE_BY_LABEL = 'save_by_label'
SAVE_BY_TRAIN_VALID = 'save_by_train_valid'
DATA_FORMAT = 'data_format'
DATA_FORMAT_ARGS = 'data_format_args'
STRUCTURE_LIST = 'structure_list'
LOAD_DATASET = 'load_dataset_path'
LOAD_TRAINSET = 'load_trainset_path'
LOAD_VALIDSET = 'load_validset_path'
LOAD_TESTSET = 'load_testset_path'
FORMAT_OUTPUTS = 'format_outputs_for_ase'
COMPUTE_STATISTICS = 'compute_statistics'
DATASET_TYPE = 'dataset_type'

RANDOM_SEED = 'random_seed'
RATIO = 'data_divide_ratio'
USE_TESTSET = 'use_testset'
EPOCH = 'epoch'
LOSS = 'loss'
LOSS_PARAM = 'loss_param'
OPTIMIZER = 'optimizer'
OPTIM_PARAM = 'optim_param'
SCHEDULER = 'scheduler'
SCHEDULER_PARAM = 'scheduler_param'
FORCE_WEIGHT = 'force_loss_weight'
STRESS_WEIGHT = 'stress_loss_weight'
DEVICE = 'device'
DTYPE = 'dtype'
TRAIN_SHUFFLE = 'train_shuffle'
IS_TRAIN_STRESS = 'is_train_stress'

CONTINUE = 'continue'
CHECKPOINT = 'checkpoint'
RESET_OPTIMIZER = 'reset_optimizer'
RESET_SCHEDULER = 'reset_scheduler'
RESET_EPOCH = 'reset_epoch'
USE_STATISTIC_VALUES_OF_CHECKPOINT = 'use_statistic_values_of_checkpoint'

CSV_LOG = 'csv_log'
ERROR_RECORD = 'error_record'
BEST_METRIC = 'best_metric'
NUM_WORKERS = 'num_workers'

RANK = 'rank'
LOCAL_RANK = 'local_rank'
WORLD_SIZE = 'world_size'
IS_DDP = 'is_ddp'
DDP_BACKEND = 'ddp_backend'
PER_EPOCH = 'per_epoch'

USE_WEIGHT = 'use_weight'
USE_MODALITY = 'use_modality'
DEFAULT_MODAL = 'default_modal'

# -- model configuration keys -----------------------------------------------
MODEL_TYPE = '_model_type'
CUTOFF = 'cutoff'
CHEMICAL_SPECIES = 'chemical_species'
MODAL_LIST = 'modal_list'
CHEMICAL_SPECIES_BY_ATOMIC_NUMBER = '_chemical_species_by_atomic_number'
NUM_SPECIES = '_number_of_species'
NUM_MODALITIES = '_number_of_modalities'
TYPE_MAP = '_type_map'
MODAL_MAP = '_modal_map'
MULTI_CUTOFF = 'multi_cutoff'

IRREPS_MANUAL = 'irreps_manual'
NODE_FEATURE_MULTIPLICITY = 'channel'

RADIAL_BASIS = 'radial_basis'
BESSEL_BASIS_NUM = 'bessel_basis_num'

CUTOFF_FUNCTION = 'cutoff_function'
POLY_CUT_P = 'poly_cut_p_value'

LMAX = 'lmax'
LMAX_EDGE = 'lmax_edge'
LMAX_NODE = 'lmax_node'
IS_PARITY = 'is_parity'
CONVOLUTION_WEIGHT_NN_HIDDEN_NEURONS = 'weight_nn_hidden_neurons'
NUM_CONVOLUTION = 'num_convolution_layer'
ACTIVATION_SCARLAR = 'act_scalar'
ACTIVATION_GATE = 'act_gate'
ACTIVATION_RADIAL = 'act_radial'

SELF_CONNECTION_TYPE = 'self_connection_type'
RADIAL_BASIS_NAME = 'radial_basis_name'
CUTOFF_FUNCTION_NAME = 'cutoff_function_name'
USE_BIAS_IN_LINEAR = 'use_bias_in_linear'

USE_MODAL_NODE_EMBEDDING = 'use_modal_node_embedding'
USE_MODAL_SELF_INTER_INTRO = 'use_modal_self_inter_intro'
USE_MODAL_SELF_INTER_OUTRO = 'use_modal_self_inter_outro'
USE_MODAL_OUTPUT_BLOCK = 'use_modal_output_block'

READOUT_AS_FCN = 'readout_as_fcn'
READOUT_FCN_HIDDEN_NEURONS = 'readout_fcn_hidden_neurons'
READOUT_FCN_ACTIVATION = 'readout_fcn_activation'

AVG_NUM_NEIGH = 'avg_num_neigh'
CONV_DENOMINATOR = 'conv_denominator'
SHIFT = 'shift'
SCALE = 'scale'

USE_SPECIES_WISE_SHIFT_SCALE = 'use_species_wise_shift_scale'
USE_MODAL_WISE_SHIFT = 'use_modal_wise_shift'
USE_MODAL_WISE_SCALE = 'use_modal_wise_scale'

TRAIN_SHIFT_SCALE = 'train_shift_scale'
TRAIN_DENOMINTAOR = 'train_denominator'
INTERACTION_TYPE = 'interaction_type'

_NORMALIZE_SPH = '_normalize_sph'
