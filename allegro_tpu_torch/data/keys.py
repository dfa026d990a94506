"""Well-known field names for atomic data dicts.

The same names as ``allegro_tpu/data/keys.py``, so a data dict means the same
thing in both packages: ``EDGE_INDEX`` row 0 is the center atom, row 1 the
neighbor; padded edges carry the sentinel center ``n_atoms``. The TPU block
plan, rank-identity and window keys are not carried over: the port's kernels
read CSR row pointers instead (``CENTER_ROW_PTR`` over the center-sorted
edges, ``NBR_ROW_PTR`` over the neighbor-sorted order ``NBR_PERM``).
"""

# --- per-atom ---
POSITIONS = "pos"                     # [N, 3] float
ATOM_TYPES = "atom_types"             # [N] int32
ATOMIC_NUMBERS = "atomic_numbers"     # [N] int32
NODE_MASK = "node_mask"               # [N] bool — True for real atoms
BATCH = "batch"                       # [N] int32 — frame index per atom
FORCES = "forces"                     # [N, 3] float (target or output)
PER_ATOM_ENERGY = "atomic_energy"     # [N, 1] float

# --- per-edge ---
EDGE_INDEX = "edge_index"             # [2, E] int32 (row 0 center, row 1 neighbor)
EDGE_CELL_SHIFT = "edge_cell_shift"   # [E, 3] float — integer cell offsets
EDGE_MASK = "edge_mask"               # [E] bool — True for real edges
EDGE_VECTORS = "edge_vectors"         # [E, 3]
EDGE_LENGTH = "edge_length"           # [E, 1]
NORM_LENGTH = "norm_length"           # [E, 1] — r/r_max
EDGE_TYPE = "edge_type"               # [E] int32 — center_type * n_types + neighbor_type
EDGE_CUTOFF = "edge_cutoff"           # [E, 1] — smooth cutoff envelope value
EDGE_EMBEDDING = "edge_embedding"     # [E, D] — two-body scalar embedding
EDGE_ATTRS = "edge_attrs"             # [E, dim] — SH tensor basis (mul=1)
EDGE_FEATURES = "edge_features"       # [E, dim*mul] — flat dim-major tensor track
EDGE_FEATURE_WEIGHTS = "edge_feature_weights"  # [E, n_irr*mul] — the tensor embed's
                                      # channel weights: EDGE_FEATURES = sh ⊗ weights,
                                      # in the factor form the layer-0 kernel reads
EDGE_SCALARS = "edge_scalars"         # tuple of [E, S] blocks — scalar track
EDGE_ENERGY = "edge_energy"           # [E, 1]

# --- precomputed per-neighbor-list statics (position-independent) ---
# CSR row pointer over the center-sorted edges: edges of atom a are
# [row_ptr[a], row_ptr[a+1]); sentinel (padded) edges lie at and after
# row_ptr[n_atoms]
CENTER_ROW_PTR = "center_row_ptr"     # [N+1] int32
# the edges sorted by neighbor (stable, sentinel neighbors last): NBR_PERM[k]
# is the k-th edge in that order, and NBR_ROW_PTR its CSR row pointer, so the
# edges whose neighbor is atom a are NBR_PERM[NBR_ROW_PTR[a]:NBR_ROW_PTR[a+1]]
NBR_PERM = "nbr_perm"                 # [E] int32
NBR_ROW_PTR = "nbr_row_ptr"           # [N+1] int32
# marker (a 0-d bool, value unused): the real centers are the atoms 0..max,
# each with an edge (JAX's key: its rank plan is then the identity). JAX's
# fused readout runs only with it, and a bfloat16 model's per-atom energy
# takes its dtype from which readout ran (FusedEdgeReadoutSum), so
# Model.precompute_statics attaches it for a bfloat16 model
CENTER_RANK_IDENTITY = "center_rank_identity"
# Class CSRs of the parameter tables read per edge or per atom by a class
# (the type embeddings, the spline's per-edge-type weights, the trainable
# per-type scales and shifts). For lookup L, ``L_idx`` [M] int32 is the row
# each edge or atom reads (the table's row count on padded ones: a row that
# reads zeros and adds nothing), ``L_perm`` [M] its stable argsort and
# ``L_row_ptr`` [rows+1] the CSR row pointer over that order: the read is
# ``center_gather`` and the table's gradient ``center_sum``, in a fixed order.
CENTER_TYPE_LOOKUP = "center_type"    # per edge, num_types rows
NEIGHBOR_TYPE_LOOKUP = "neighbor_type"  # per edge, num_types rows
EDGE_CLASS_LOOKUP = "edge_class"      # per edge, num_types² rows
ATOM_TYPE_LOOKUP = "atom_type"        # per atom, num_types rows


def class_csr_keys(lookup: str):
    """The keys ``(idx, row_ptr, perm)`` of a lookup's class CSR."""
    return f"{lookup}_idx", f"{lookup}_row_ptr", f"{lookup}_perm"


# --- per-frame ---
CELL = "cell"                         # [F, 3, 3] float (rows are lattice vectors)
PBC = "pbc"                           # [F, 3] bool
TOTAL_ENERGY = "total_energy"         # [F, 1]
STRESS = "stress"                     # [F, 3, 3]
VIRIAL = "virial"                     # [F, 3, 3]
NUM_NODES = "num_nodes"               # [F] int32 — real atoms per frame
FRAME_MASK = "frame_mask"             # [F] bool — True for real frames

ALL_KEYS = [v for k, v in list(globals().items()) if k.isupper() and isinstance(v, str)]

# Fields that are per-atom / per-edge / per-frame (used by padding & batching).
PER_ATOM_FIELDS = {
    POSITIONS,
    ATOM_TYPES,
    ATOMIC_NUMBERS,
    NODE_MASK,
    BATCH,
    FORCES,
    PER_ATOM_ENERGY,
}
PER_EDGE_FIELDS = {
    EDGE_INDEX,
    EDGE_CELL_SHIFT,
    EDGE_MASK,
    EDGE_VECTORS,
    EDGE_LENGTH,
    NORM_LENGTH,
    EDGE_TYPE,
    EDGE_CUTOFF,
    EDGE_EMBEDDING,
    EDGE_ATTRS,
    EDGE_FEATURES,
    EDGE_SCALARS,
    EDGE_ENERGY,
}
PER_FRAME_FIELDS = {
    CELL,
    PBC,
    TOTAL_ENERGY,
    STRESS,
    VIRIAL,
    NUM_NODES,
    FRAME_MASK,
}
