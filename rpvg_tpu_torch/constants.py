"""Numeric contract constants shared with the reference engine.

Values cited from the reference (rpvg) so outputs are comparable:
reference/src/utils.hpp:81-84,503-505 and
reference/src/main.cpp:41-42,380-419.
"""

import sys

# Alignment-score -> likelihood conversion base: likelihood = exp(score * SCORE_LOG_BASE)
# (reference src/utils.hpp:83)
SCORE_LOG_BASE = 1.383325268738

# Noise scores are stored as integers scaled by this base (src/utils.hpp:84).
NOISE_SCORE_LOG_BASE = 1e-6

# GSSW-style scoring parameters (src/utils.hpp:503-505).
MATCH_SCORE = 1
MISMATCH_SCORE = 4
FULL_LENGTH_BONUS = 5

# Relative tolerance used when comparing doubles (src/utils.hpp:81).
DOUBLE_PRECISION = sys.float_info.epsilon * 100

# Multipath noise-branch prune bound (src/alignment_path_finder.cpp:11).
MAX_NOISE_SCORE_DIFF = (MATCH_SCORE + MISMATCH_SCORE) * 2

# Fragment-length histogram gating (src/main.cpp:41-42).
FRAG_LENGTH_MIN_MAPQ = 30

# EM convergence parameters (src/path_abundance_estimator.cpp:10-11).
MIN_EM_CONV_ITS = 10
MIN_EM_ABUNDANCE = 1e-8

# Read-count Gibbs sampler (src/path_abundance_estimator.cpp:13-14).
ABUNDANCE_GIBBS_GAMMA = 1.0
MIN_GIBBS_ABUNDANCE = 1e-8

# Haplotype-posterior Gibbs sizing (src/path_estimator.cpp:4-11).
MIN_GIBBS_CHAINS = 10
GIBBS_CHAIN_SCALING = 0.01
MIN_BURN_ITS = 50
BURN_ITS_SCALING = 0.025
MIN_GIBBS_ITS = 100
GIBBS_ITS_SCALING = 0.05

# Diploid posterior pruning threshold for the `haplotypes` model
# (src/path_posterior_estimator.cpp:5).
HAPLOTYPES_MIN_REL_LIKELIHOOD = 1e-8

# Output float precision in digits (src/threaded_output_writer.cpp:6).
OUT_PRECISION_DIGITS = 8

# int32 bounds used by the reference when clamping log-noise scores.
INT32_MAX = 2**31 - 1
INT32_MIN = -(2**31)

# GBWT-style node encoding: node = 2 * node_id + is_reverse.  The
# endmarker (id 0, forward) terminates sequences.
ENDMARKER = 0


def encode_node(node_id: int, is_reverse: bool) -> int:
    """GBWT node encoding (gbwt::Node::encode)."""
    return 2 * node_id + int(is_reverse)


def node_id(node: int) -> int:
    return node >> 1


def node_is_reverse(node: int) -> bool:
    return bool(node & 1)


def flip_node(node: int) -> int:
    return node ^ 1


def double_compare(a: float, b: float) -> bool:
    """Relative comparison mirroring reference Utils::doubleCompare."""
    return a == b or abs(a - b) < abs(min(a, b)) * DOUBLE_PRECISION


def double_to_int(value: float) -> int:
    """Clamp-and-round to int32 (reference Utils::doubleToInt)."""
    return int(round(min(float(INT32_MAX), max(float(INT32_MIN), value))))
