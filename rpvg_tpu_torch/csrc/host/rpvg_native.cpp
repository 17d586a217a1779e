// rpvg_native — C++ host kernels for the rpvg_tpu projection engine.
//
// Implements the irregular, data-dependent front half of the pipeline
// (haplotype-panel substring search and alignment->path projection) as a
// shared library with a C ABI, mirroring the semantics of the tested
// Python engine (rpvg_tpu/projection.py; behavioural contract ultimately
// reference/src/alignment_path_finder.cpp).  The Python engine
// remains the readable specification; this library is the speed path.
//
// Interface: batches of fragments are serialized into a compact binary
// buffer by the Python wrapper (rpvg_tpu/native.py), processed here, and
// results (finalized alignment paths incl. search-state occurrence
// positions) are returned as a malloc'd buffer.

#include <algorithm>
#include <atomic>
#include <cassert>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <random>
#include <limits>
#include <string>
#include <string_view>
#include <thread>
#include <map>
#include <functional>
#include <unordered_map>
#include <vector>

namespace {

constexpr int64_t ENDMARKER = 0;
constexpr double SCORE_LOG_BASE = 1.383325268738;
constexpr double NOISE_SCORE_LOG_BASE = 1e-6;
constexpr int32_t MATCH_SCORE = 1;
constexpr int32_t MISMATCH_SCORE = 4;
constexpr int32_t FULL_LENGTH_BONUS = 5;
constexpr int32_t MAX_NOISE_SCORE_DIFF = (MATCH_SCORE + MISMATCH_SCORE) * 2;
constexpr int32_t INT32_MAX_V = std::numeric_limits<int32_t>::max();
constexpr int32_t INT32_MIN_V = std::numeric_limits<int32_t>::min();
constexpr double LOWEST = static_cast<double>(INT32_MIN_V);

inline double add_log(double log_x, double log_y) {
  return log_x > log_y ? log_x + std::log1p(std::exp(log_y - log_x))
                       : log_y + std::log1p(std::exp(log_x - log_y));
}

inline int32_t double_to_int(double value) {
  double clamped = std::min(static_cast<double>(INT32_MAX_V),
                            std::max(static_cast<double>(INT32_MIN_V), value));
  return static_cast<int32_t>(std::llround(clamped));
}

// ---------------------------------------------------------------- index

struct Index {
  std::vector<int64_t> concat;      // panel sequences + endmarker separators
  std::vector<int64_t> seq_starts;  // start offset per sequence
  std::vector<int64_t> occ_offsets; // CSR over encoded nodes
  std::vector<int64_t> occ_positions;
  std::vector<int64_t> edge_offsets; // distinct successors per encoded node
  std::vector<int64_t> edge_targets;
  std::vector<uint8_t> node_in_cycle; // some sequence visits the node twice
  std::vector<int32_t> node_lengths; // by node id (-1 = absent)
  bool bidirectional = false;
  int64_t max_enc_node = 0;

  bool has_node_id(int64_t node_id) const {
    return node_id >= 0 && node_id < static_cast<int64_t>(node_lengths.size()) &&
           node_lengths[node_id] >= 0;
  }
  int32_t node_length(int64_t node_id) const { return node_lengths[node_id]; }
};

// Search state: occurrence positions of the matched suffix's last node.
// RPVG_TPU_NATIVE_PROF=1: projection sub-phase thread-CPU accounting.
static std::atomic<uint64_t> g_prof_extend_ns{0};
static std::atomic<uint64_t> g_prof_pair_ns{0};
static std::atomic<uint64_t> g_prof_prescan_ns{0};
static bool prof_on() {
  static const bool on = [] {
    const char* env = std::getenv("RPVG_TPU_NATIVE_PROF");
    return env != nullptr && env[0] == '1';
  }();
  return on;
}
static uint64_t prof_now() {
  timespec ts;
  clock_gettime(CLOCK_THREAD_CPUTIME_ID, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}
static uint64_t prof_wall() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return static_cast<uint64_t>(ts.tv_sec) * 1000000000ull + ts.tv_nsec;
}

struct SearchState {
  int64_t node = ENDMARKER;
  std::vector<int64_t> positions;

  bool empty() const { return positions.empty(); }
  size_t size() const { return positions.size(); }
};

void index_find(const Index& idx, int64_t node, SearchState* state) {
  state->node = node;
  state->positions.clear();
  if (node >= 0 && node <= idx.max_enc_node) {
    int64_t begin = idx.occ_offsets[node];
    int64_t end = idx.occ_offsets[node + 1];
    state->positions.assign(idx.occ_positions.begin() + begin,
                            idx.occ_positions.begin() + end);
  }
}

// Filter `src` positions through one extension step into `dst`
// (reusable buffer — no allocation once capacity is warm).
void index_extend_into(const Index& idx, const std::vector<int64_t>& src,
                       int64_t node, std::vector<int64_t>* dst) {
  dst->clear();
  for (int64_t pos : src) {
    int64_t next = pos + 1;
    if (idx.concat[next] == node) dst->push_back(next);
  }
}

void index_extend(const Index& idx, SearchState* state, int64_t node) {
  if (state->positions.empty()) {
    state->node = node;
    return;
  }
  size_t out = 0;
  for (size_t i = 0; i < state->positions.size(); ++i) {
    int64_t next = state->positions[i] + 1;
    if (idx.concat[next] == node) {
      state->positions[out++] = next;
    }
  }
  state->positions.resize(out);
  state->node = node;
}

// ------------------------------------------------------------ alignments

struct MappingRec {
  int64_t node;
  int32_t offset;
  int32_t to_length;
  int32_t from_length;
  int32_t first_edit_from, first_edit_to;
  int32_t last_edit_from, last_edit_to;
};

struct PathRec {
  std::vector<MappingRec> mappings;
};

struct SubpathRec {
  PathRec path;
  std::vector<int32_t> next;
  int32_t n_connections = 0;
  int32_t score = 0;
};

struct AlignmentRec {
  int32_t seq_len = 0;
  int32_t mapq = 0;
  int32_t allelic_mapq = -1; // -1 = absent
  int32_t score = 0;         // single-path score
  bool is_multipath = false;
  bool disconnected = false;
  PathRec path;                       // single-path
  std::vector<SubpathRec> subpaths;   // multipath
  std::vector<int32_t> starts;
  std::vector<uint8_t> quality;       // empty = no qualities
};

// Lazy reverse complement (offsets flipped, edits reversed; reference
// utils.hpp:341-479 semantics on the compact record).
MappingRec rc_mapping(const MappingRec& m, const Index& idx) {
  MappingRec out = m;
  int64_t node_id = m.node >> 1;
  int32_t node_len = idx.node_length(node_id);
  out.offset = node_len - m.from_length - m.offset;
  out.node = m.node ^ 1;
  out.first_edit_from = m.last_edit_from;
  out.first_edit_to = m.last_edit_to;
  out.last_edit_from = m.first_edit_from;
  out.last_edit_to = m.first_edit_to;
  return out;
}

PathRec rc_path(const PathRec& p, const Index& idx) {
  PathRec out;
  out.mappings.reserve(p.mappings.size());
  for (auto it = p.mappings.rbegin(); it != p.mappings.rend(); ++it) {
    out.mappings.push_back(rc_mapping(*it, idx));
  }
  return out;
}

AlignmentRec rc_alignment(const AlignmentRec& a, const Index& idx) {
  AlignmentRec out;
  out.seq_len = a.seq_len;
  out.mapq = a.mapq;
  out.score = a.score;
  out.is_multipath = a.is_multipath;
  out.disconnected = a.disconnected;
  out.quality.assign(a.quality.rbegin(), a.quality.rend());

  if (!a.is_multipath) {
    out.path = rc_path(a.path, idx);
    return out;
  }

  size_t n = a.subpaths.size();
  std::vector<std::vector<int32_t>> reverse_edges(n);
  std::vector<int32_t> reverse_starts;
  out.subpaths.resize(n);
  for (int64_t i = n - 1; i >= 0; --i) {
    const SubpathRec& sp = a.subpaths[i];
    SubpathRec& rc_sp = out.subpaths[n - 1 - i];
    rc_sp.path = rc_path(sp.path, idx);
    rc_sp.score = sp.score;
    rc_sp.n_connections = 0;
    if (!sp.next.empty() || sp.n_connections > 0) {
      for (int32_t nxt : sp.next) reverse_edges[nxt].push_back(i);
    } else {
      reverse_starts.push_back(i);
    }
  }
  for (size_t i = 0; i < n; ++i) {
    for (int32_t src : reverse_edges[n - 1 - i]) {
      out.subpaths[i].next.push_back(static_cast<int32_t>(n - 1 - src));
    }
  }
  if (!a.starts.empty()) {
    for (int32_t s : reverse_starts) {
      out.starts.push_back(static_cast<int32_t>(n - 1 - s));
    }
  }
  return out;
}

// -------------------------------------------------------------- scoring

struct ScoreTables {
  int32_t match_scores[256];
  int32_t bonuses[256];
};

int32_t alignment_score(const ScoreTables& tables, const AlignmentRec& aln,
                        bool score_not_qual, int32_t start, int32_t length) {
  if (score_not_qual || aln.quality.empty()) return length;
  int32_t score = 0;
  for (int32_t i = start; i < start + length; ++i) {
    score += tables.match_scores[aln.quality[i]];
  }
  return score;
}

int32_t optimal_alignment_score(const ScoreTables& tables, const AlignmentRec& aln,
                                bool score_not_qual) {
  if (score_not_qual || aln.quality.empty()) {
    return aln.seq_len * MATCH_SCORE + 2 * FULL_LENGTH_BONUS;
  }
  int32_t score = alignment_score(tables, aln, score_not_qual, 0, aln.seq_len);
  score += tables.bonuses[aln.quality.front()] + tables.bonuses[aln.quality.back()];
  return score;
}

// -------------------------------------------------------- search paths

struct InternalAlignment {
  bool is_internal = false;
  int32_t penalty = 0;
  int32_t offset = 0;
  int32_t max_offset = 0;

  bool operator==(const InternalAlignment& o) const {
    return is_internal == o.is_internal && penalty == o.penalty &&
           offset == o.offset && max_offset == o.max_offset;
  }
  int compare(const InternalAlignment& o) const {
    if (is_internal != o.is_internal) return is_internal < o.is_internal ? -1 : 1;
    if (penalty != o.penalty) return penalty < o.penalty ? -1 : 1;
    if (offset != o.offset) return offset < o.offset ? -1 : 1;
    if (max_offset != o.max_offset) return max_offset < o.max_offset ? -1 : 1;
    return 0;
  }
};

struct AlignmentStats {
  int32_t score = 0;
  int32_t length = 0;
  bool complete = false;
  int32_t left_softclip = 0;
  int32_t right_softclip = 0;
  InternalAlignment internal_start;
  InternalAlignment internal_end;
  int64_t internal_end_next_node = ENDMARKER;

  bool is_internal() const {
    return internal_start.is_internal || internal_end.is_internal;
  }
  int32_t adjusted_score() const {
    return score - internal_start.penalty - internal_end.penalty;
  }
  int32_t clipped_left() const { return left_softclip + internal_start.offset; }
  int32_t clipped_right() const { return right_softclip + internal_end.offset; }
  int32_t clipped_total() const { return clipped_left() + clipped_right(); }

  void update_left_softclip(const PathRec& path) {
    const MappingRec& m = path.mappings.front();
    left_softclip = (m.first_edit_from == 0) ? m.first_edit_to : 0;
  }
  void update_right_softclip(const PathRec& path) {
    const MappingRec& m = path.mappings.back();
    right_softclip = (m.last_edit_from == 0) ? m.last_edit_to : 0;
  }

  int compare(const AlignmentStats& o) const {
    if (score != o.score) return score < o.score ? -1 : 1;
    if (length != o.length) return length < o.length ? -1 : 1;
    if (complete != o.complete) return complete < o.complete ? -1 : 1;
    if (left_softclip != o.left_softclip) return left_softclip < o.left_softclip ? -1 : 1;
    if (right_softclip != o.right_softclip) return right_softclip < o.right_softclip ? -1 : 1;
    int c = internal_start.compare(o.internal_start);
    if (c) return c;
    c = internal_end.compare(o.internal_end);
    if (c) return c;
    if (internal_end_next_node != o.internal_end_next_node)
      return internal_end_next_node < o.internal_end_next_node ? -1 : 1;
    return 0;
  }
};

struct SearchPath {
  std::vector<int64_t> path;
  SearchState search;
  int32_t start_offset = 0;
  int32_t end_offset = 0;
  int32_t insert_length = 0;
  std::vector<AlignmentStats> read_stats;

  void clear() {
    path.clear();
    search.node = ENDMARKER;
    search.positions.clear();
  }

  int32_t alignment_length() const {
    if (read_stats.size() == 1) {
      return read_stats[0].length - read_stats[0].clipped_total();
    }
    return read_stats.front().length + read_stats.back().length -
           read_stats.front().clipped_total() - read_stats.back().clipped_total();
  }

  int32_t fragment_length() const {
    if (read_stats.size() == 1) {
      if (insert_length == 0) return read_stats[0].length;
      return read_stats[0].length + insert_length - read_stats[0].clipped_right();
    }
    return read_stats.front().length + read_stats.back().length + insert_length -
           read_stats.front().clipped_right() - read_stats.back().clipped_left();
  }

  int32_t score_sum() const {
    int32_t total = 0;
    for (const auto& s : read_stats) total += s.adjusted_score();
    return total;
  }

  double min_optimal_score_fraction(const std::vector<int32_t>& optimal) const {
    double frac = 1.0;
    for (size_t i = 0; i < read_stats.size(); ++i) {
      frac = std::min(frac, read_stats[i].adjusted_score() /
                                static_cast<double>(optimal[i]));
    }
    return std::max(0.0, frac);
  }

  bool is_complete() const {
    for (const auto& s : read_stats) {
      if (!s.complete) return false;
    }
    return true;
  }

  bool is_internal() const {
    for (const auto& s : read_stats) {
      if (s.is_internal()) return true;
    }
    return false;
  }

  // Ordering matching the Python engine's SearchPath.sort_key (itself
  // mirroring reference operator<): by path length, path content,
  // insert length, score, stats, offsets — all integers.
  bool sort_greater(const SearchPath& o) const {
    if (path.size() != o.path.size()) return path.size() > o.path.size();
    for (size_t i = 0; i < path.size(); ++i) {
      if (path[i] != o.path[i]) return path[i] > o.path[i];
    }
    if (insert_length != o.insert_length) return insert_length > o.insert_length;
    int32_t s1 = score_sum(), s2 = o.score_sum();
    if (s1 != s2) return s1 > s2;
    if (read_stats.size() != o.read_stats.size())
      return read_stats.size() > o.read_stats.size();
    for (size_t i = 0; i < read_stats.size(); ++i) {
      int c = read_stats[i].compare(o.read_stats[i]);
      if (c) return c > 0;
    }
    if (start_offset != o.start_offset) return start_offset > o.start_offset;
    return end_offset > o.end_offset;
  }
};

struct AlignmentPathOut {
  SearchState search;
  bool is_simple;
  int32_t mapq;
  int32_t score_sum;
  int32_t align_length;
  int32_t frag_length;
};

// ---------------------------------------------------------------- finder

struct Params {
  int32_t library_type = 0;  // 0=unstranded, 1=fr, 2=rf
  int32_t score_not_qual = 0;
  int32_t max_pair_frag_length = 1000;
  int32_t max_partial_offset = 4;
  int32_t est_missing_noise_prob = 0;
  int32_t max_score_diff = 20;
  int32_t use_allelic_mapq = 0;
  double min_best_score_filter = 0.9;
};

int32_t resolve_mapq(const Params& p, const AlignmentRec& aln) {
  if (p.use_allelic_mapq && aln.allelic_mapq >= 0) {
    return std::min(aln.allelic_mapq, aln.mapq);
  }
  return aln.mapq;
}

class Finder {
 public:
  Finder(const Index& index, const Params& params, const ScoreTables& tables)
      : idx_(index), p_(params), tables_(tables) {}

  // Returns empty vector for unaligned fragments.
  std::vector<AlignmentPathOut> find_single(const AlignmentRec& aln) const {
    if (!has_path(aln) || !starts_in_graph(aln)) return {};
    std::vector<SearchPath> search_paths;
    if (p_.library_type == 1) {
      find_single_search_paths(&search_paths, aln);
    } else if (p_.library_type == 2) {
      AlignmentRec rc = rc_alignment(aln, idx_);
      find_single_search_paths(&search_paths, rc);
    } else {
      find_single_search_paths(&search_paths, aln);
      if (!idx_.bidirectional) {
        AlignmentRec rc = rc_alignment(aln, idx_);
        find_single_search_paths(&search_paths, rc);
      }
    }
    return finalize(search_paths, aln.disconnected, resolve_mapq(p_, aln));
  }

  std::vector<AlignmentPathOut> find_paired(const AlignmentRec& aln_1,
                                            const AlignmentRec& aln_2) const {
    if (!has_path(aln_1) || !has_path(aln_2)) return {};
    if (!starts_in_graph(aln_1) || !starts_in_graph(aln_2)) return {};

    std::vector<SearchPath> paired;
    if (p_.library_type == 1) {
      AlignmentRec rc2 = rc_alignment(aln_2, idx_);
      find_paired_search_paths(&paired, aln_1, rc2);
    } else if (p_.library_type == 2) {
      AlignmentRec rc1 = rc_alignment(aln_1, idx_);
      find_paired_search_paths(&paired, aln_2, rc1);
    } else {
      AlignmentRec rc2 = rc_alignment(aln_2, idx_);
      find_paired_search_paths(&paired, aln_1, rc2);
      if (!idx_.bidirectional) {
        AlignmentRec rc1 = rc_alignment(aln_1, idx_);
        find_paired_search_paths(&paired, aln_2, rc1);
      }
    }
    bool is_multimap = aln_1.disconnected || aln_2.disconnected;
    int32_t mapq = std::min(resolve_mapq(p_, aln_1), resolve_mapq(p_, aln_2));
    return finalize(paired, is_multimap, mapq);
  }

 private:
  const Index& idx_;
  const Params& p_;
  const ScoreTables& tables_;
  // Reusable per-Finder scratch (one Finder per worker thread): the
  // pair-completion maps and per-depth extension buffers would
  // otherwise allocate per fragment / per explored edge.
  mutable std::unordered_map<int64_t, uint32_t> end_node_counts_;
  mutable std::unordered_map<int64_t, std::vector<uint32_t>> end_start_node_index_;
  mutable std::vector<std::vector<int64_t>> depth_scratch_;

  static bool has_path(const AlignmentRec& aln) {
    return aln.is_multipath ? !aln.subpaths.empty() : !aln.path.mappings.empty();
  }

  bool starts_in_graph(const AlignmentRec& aln) const {
    if (aln.is_multipath) {
      for (int32_t s : aln.starts) {
        int64_t node = aln.subpaths[s].path.mappings.front().node;
        if (!idx_.has_node_id(node >> 1)) return false;
      }
      return true;
    }
    return idx_.has_node_id(aln.path.mappings.front().node >> 1);
  }

  // ------------------------------------------------ node-level extension
  void extend_with_mapping(SearchPath* sp, const MappingRec& mapping) const {
    int64_t cur_node = mapping.node;
    if (sp->path.empty()) {
      sp->path.push_back(cur_node);
      index_find(idx_, cur_node, &sp->search);
      sp->start_offset = mapping.offset;
    } else {
      bool is_cycle_visit =
          sp->path.back() == cur_node && mapping.offset != sp->end_offset;
      if (is_cycle_visit && mapping.offset != 0) {
        sp->clear();
      } else if (sp->path.back() != cur_node || is_cycle_visit) {
        sp->path.push_back(cur_node);
        if (!sp->search.empty()) index_extend(idx_, &sp->search, cur_node);
      }
    }
    sp->end_offset = mapping.offset + mapping.from_length;
  }

  // ------------------------------------------------ path-level extension
  void extend_with_path(std::vector<SearchPath>* paths, const PathRec& graph_path,
                        bool is_first_path, bool is_last_path,
                        const AlignmentRec& aln, bool add_internal_start) const {
    if (is_first_path) paths->front().read_stats.back().update_left_softclip(graph_path);
    if (is_last_path) paths->front().read_stats.back().update_right_softclip(graph_path);

    size_t last_internal_start_idx = 0;
    size_t first_main_idx = 0;
    int32_t seq_length = aln.seq_len;
    size_t n_mappings = graph_path.mappings.size();

    for (size_t m_idx = 0; m_idx < n_mappings; ++m_idx) {
      const MappingRec& mapping = graph_path.mappings[m_idx];
      int64_t cur_node = mapping.node;
      int32_t mapping_read_length = mapping.to_length;
      bool is_last_mapping = is_last_path && m_idx == n_mappings - 1;

      // Select the "main" candidate for a partial-at-end branch.
      bool have_main = false;
      SearchPath main_path;
      if (p_.max_partial_offset > 0 && !paths->front().path.empty()) {
        while (first_main_idx < paths->size()) {
          SearchPath& candidate = (*paths)[first_main_idx];
          if (candidate.search.empty() ||
              candidate.read_stats.back().internal_end.is_internal) {
            ++first_main_idx;
            continue;
          }
          if (seq_length - candidate.read_stats.back().length <=
              candidate.read_stats.back().internal_end.max_offset) {
            main_path = candidate;
            have_main = true;
          }
          break;
        }
      }

      for (auto& sp : *paths) {
        AlignmentStats& stats = sp.read_stats.back();
        if (stats.internal_end.is_internal) {
          int32_t delta = mapping_read_length;
          if (is_last_mapping) delta -= stats.right_softclip;
          stats.internal_end.offset += delta;
          if (stats.internal_end.offset <= p_.max_partial_offset) {
            stats.internal_end.penalty +=
                alignment_score(tables_, aln, p_.score_not_qual, stats.length, delta);
          } else {
            sp.clear();
          }
        } else {
          extend_with_mapping(&sp, mapping);
        }
      }

      if (have_main) {
        const SearchPath& candidate = (*paths)[first_main_idx];
        if (main_path.search.size() > candidate.search.size()) {
          AlignmentStats& mstats = main_path.read_stats.back();
          mstats.internal_end.is_internal = true;
          mstats.internal_end.offset = mapping_read_length;
          if (is_last_mapping) mstats.internal_end.offset -= mstats.right_softclip;
          if (mstats.internal_end.offset <= p_.max_partial_offset) {
            mstats.internal_end_next_node = cur_node;
            mstats.internal_end.penalty = alignment_score(
                tables_, aln, p_.score_not_qual, mstats.length,
                mstats.internal_end.offset);
            paths->push_back(std::move(main_path));
          }
        }
      }

      if (p_.max_partial_offset > 0 && add_internal_start &&
          (*paths)[last_internal_start_idx].path.size() > 1 &&
          !(*paths)[last_internal_start_idx].read_stats.back().internal_end.is_internal) {
        const AlignmentStats& anchor = (*paths)[last_internal_start_idx].read_stats.back();
        if (anchor.length <= anchor.internal_start.max_offset) {
          AlignmentStats new_stats = anchor;
          new_stats.internal_start.is_internal = true;
          new_stats.internal_start.offset = new_stats.length - new_stats.left_softclip;
          if (new_stats.internal_start.offset <= p_.max_partial_offset) {
            SearchPath fresh;
            extend_with_mapping(&fresh, mapping);
            if (!fresh.search.empty() &&
                fresh.search.size() > (*paths)[last_internal_start_idx].search.size()) {
              new_stats.internal_start.penalty = alignment_score(
                  tables_, aln, p_.score_not_qual, new_stats.left_softclip,
                  new_stats.internal_start.offset);
              fresh.read_stats.assign(1, new_stats);
              paths->push_back(std::move(fresh));
              last_internal_start_idx = paths->size() - 1;
            }
          }
        }
      }

      for (auto& sp : *paths) sp.read_stats.back().length += mapping_read_length;
    }
  }

  // --------------------------------------------- single-path extension
  std::vector<SearchPath> extend_with_single_path(const SearchPath& base,
                                                  const AlignmentRec& aln) const {
    int32_t optimal = optimal_alignment_score(tables_, aln, p_.score_not_qual);
    int32_t seq_length = aln.seq_len;

    std::vector<SearchPath> paths(1, base);
    AlignmentStats stats;
    stats.score = aln.score;
    stats.internal_start.max_offset = std::min(p_.max_partial_offset, seq_length);
    stats.internal_end.max_offset = std::min(p_.max_partial_offset, seq_length);
    paths[0].read_stats.push_back(stats);

    extend_with_path(&paths, aln.path, true, true, aln, true);

    int32_t max_score = 0;
    for (auto& sp : paths) {
      if ((sp.is_internal() || !p_.est_missing_noise_prob) && sp.search.empty())
        continue;
      if (sp.read_stats.back().length == seq_length) {
        sp.read_stats.back().complete = true;
        max_score = std::max(max_score, sp.score_sum());
      }
    }
    for (auto& sp : paths) {
      if (sp.read_stats.back().complete &&
          max_score - sp.score_sum() > p_.max_score_diff) {
        sp.read_stats.back().complete = false;
      }
    }
    if (below_best_score_filter(paths, {optimal})) {
      paths.push_back(make_error_sentinel(seq_length));
    }
    return paths;
  }

  // ----------------------------------------------- multipath extension
  std::vector<SearchPath> extend_with_multipath(const SearchPath& base,
                                                const AlignmentRec& aln) const {
    int32_t optimal = optimal_alignment_score(tables_, aln, p_.score_not_qual);
    int32_t seq_length = aln.seq_len;
    std::vector<SearchPath> out;

    int32_t min_right_softclip = INT32_MAX_V;
    int32_t max_right_softclip = 0;
    AlignmentStats probe;
    for (const auto& sp : aln.subpaths) {
      if (sp.next.empty()) {
        probe.update_right_softclip(sp.path);
        min_right_softclip = std::min(min_right_softclip, probe.right_softclip);
        max_right_softclip = std::max(max_right_softclip, probe.right_softclip);
      }
    }

    std::vector<std::pair<int32_t, int32_t>> start_order;
    for (int32_t s : aln.starts) start_order.push_back({aln.subpaths[s].score, s});
    std::sort(start_order.rbegin(), start_order.rend());

    std::unordered_map<int64_t, int32_t> internal_node_subpaths;
    int32_t best_align_score =
        static_cast<int32_t>(std::floor(optimal * p_.min_best_score_filter));
    bool has_right_bonus = min_right_softclip == 0;

    for (const auto& [score, start_idx] : start_order) {
      SearchPath init = base;
      AlignmentStats init_stats;
      probe.update_left_softclip(aln.subpaths[start_idx].path);
      init_stats.internal_start.max_offset =
          std::min(probe.left_softclip + p_.max_partial_offset, seq_length);
      init_stats.internal_end.max_offset =
          std::min(max_right_softclip + p_.max_partial_offset, seq_length);
      init.read_stats.push_back(init_stats);

      best_align_score =
          multipath_dfs(&out, init, aln, start_idx, internal_node_subpaths,
                        best_align_score, has_right_bonus);
    }

    for (auto& sp : out) {
      if (best_align_score - sp.score_sum() > p_.max_score_diff) {
        sp.read_stats.back().complete = false;
      }
    }
    if (below_best_score_filter(out, {optimal})) {
      out.push_back(make_error_sentinel(seq_length));
    }
    return out;
  }

  int32_t multipath_dfs(std::vector<SearchPath>* out, const SearchPath& init,
                        const AlignmentRec& aln, int32_t start_idx,
                        std::unordered_map<int64_t, int32_t>& internal_node_subpaths,
                        int32_t best_align_score, bool has_right_bonus) const {
    int32_t seq_length = aln.seq_len;
    std::vector<std::pair<SearchPath, int32_t>> stack;
    stack.push_back({init, start_idx});

    while (!stack.empty()) {
      SearchPath sp = std::move(stack.back().first);
      int32_t subpath_idx = stack.back().second;
      stack.pop_back();

      const SubpathRec& subpath = aln.subpaths[subpath_idx];
      AlignmentStats& stats = sp.read_stats.back();
      stats.score += subpath.score;

      int32_t subpath_length = 0;
      for (const auto& m : subpath.path.mappings) subpath_length += m.to_length;
      int32_t seq_left = seq_length - (stats.length + subpath_length);

      int32_t max_score = stats.score + seq_left;
      if (has_right_bonus && !subpath.next.empty()) max_score += FULL_LENGTH_BONUS;
      if (best_align_score - max_score > p_.max_score_diff) continue;

      bool add_internal_start = false;
      if (p_.max_partial_offset > 0 &&
          stats.length <= stats.internal_start.max_offset) {
        add_internal_start = true;
        int64_t memo_key =
            (static_cast<int64_t>(subpath_idx) << 32) |
            static_cast<uint32_t>(stats.length - stats.left_softclip);
        auto it = internal_node_subpaths.find(memo_key);
        if (it != internal_node_subpaths.end()) {
          if (stats.score <= it->second) add_internal_start = false;
          else it->second = stats.score;
        } else {
          internal_node_subpaths.emplace(memo_key, stats.score);
        }
      } else if (sp.search.empty()) {
        if (best_align_score - max_score > MAX_NOISE_SCORE_DIFF) continue;
      }

      std::vector<SearchPath> extended;
      extended.push_back(std::move(sp));
      extend_with_path(&extended, subpath.path, subpath_idx == start_idx,
                       subpath.next.empty(), aln, add_internal_start);

      for (auto& ext : extended) {
        if (ext.search.empty()) {
          if (ext.is_internal()) continue;
          if (!p_.est_missing_noise_prob && p_.max_partial_offset == 0) continue;
          if (!p_.est_missing_noise_prob &&
              ext.read_stats.back().length >
                  ext.read_stats.back().internal_start.max_offset)
            continue;
        }
        if (!subpath.next.empty()) {
          std::vector<std::pair<int32_t, int32_t>> next_order;
          for (int32_t n : subpath.next) next_order.push_back({aln.subpaths[n].score, n});
          std::sort(next_order.begin(), next_order.end());
          for (const auto& [nscore, next_idx] : next_order) {
            stack.push_back({ext, next_idx});
          }
        } else if (subpath.n_connections == 0) {
          best_align_score = std::max(best_align_score, ext.score_sum());
          ext.read_stats.back().complete = true;
          out->push_back(std::move(ext));
        }
      }
    }
    return best_align_score;
  }

  std::vector<SearchPath> extend_with_alignment(const SearchPath& base,
                                                const AlignmentRec& aln) const {
    return aln.is_multipath ? extend_with_multipath(base, aln)
                            : extend_with_single_path(base, aln);
  }

  // ------------------------------------------------- single-read driver
  void find_single_search_paths(std::vector<SearchPath>* out,
                                const AlignmentRec& aln) const {
    std::vector<SearchPath> candidates = extend_with_alignment(SearchPath(), aln);
    if (candidates.empty()) return;

    std::sort(candidates.begin(), candidates.end(),
              [](const SearchPath& a, const SearchPath& b) { return a.sort_greater(b); });

    double joint_score = LOWEST;
    double joint_empty_score = LOWEST;

    for (size_t i = 0; i < candidates.size(); ++i) {
      SearchPath& sp = candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.path == candidates[i - 1].path) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.search.empty()) {
        joint_empty_score = add_log(joint_empty_score, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) {
        joint_score = add_log(joint_score, score_sum * SCORE_LOG_BASE);
      }
      out->push_back(std::move(sp));
    }

    SearchPath noise;
    AlignmentStats noise_stats;
    noise_stats.score =
        double_to_int((joint_score - joint_empty_score) / NOISE_SCORE_LOG_BASE);
    noise.read_stats.push_back(noise_stats);
    out->push_back(std::move(noise));
  }

  // ------------------------------------------------- paired-end driver
  void find_paired_search_paths(std::vector<SearchPath>* out,
                                const AlignmentRec& start_aln,
                                const AlignmentRec& end_aln) const {
    uint64_t t0 = prof_on() ? prof_now() : 0;
    std::vector<SearchPath> start_candidates =
        extend_with_alignment(SearchPath(), start_aln);
    std::vector<SearchPath> end_candidates =
        extend_with_alignment(SearchPath(), end_aln);
    if (prof_on()) {
      uint64_t t1 = prof_now();
      g_prof_extend_ns.fetch_add(t1 - t0, std::memory_order_relaxed);
      t0 = t1;
    }
    struct PairProf {
      uint64_t t0; bool on;
      ~PairProf() {
        if (on) g_prof_pair_ns.fetch_add(prof_now() - t0, std::memory_order_relaxed);
      }
    } pair_prof{t0, prof_on()};
    if (start_candidates.empty() || end_candidates.empty()) return;

    auto cmp = [](const SearchPath& a, const SearchPath& b) { return a.sort_greater(b); };
    std::sort(start_candidates.begin(), start_candidates.end(), cmp);
    std::sort(end_candidates.begin(), end_candidates.end(), cmp);

    int32_t end_seq_length = end_aln.seq_len;

    uint32_t num_unique_end = 0;
    int32_t end_max_left_softclip = 0;
    auto& end_node_counts = end_node_counts_;
    auto& end_start_node_index = end_start_node_index_;
    end_node_counts.clear();
    end_start_node_index.clear();

    double joint_end = LOWEST, joint_empty_end = LOWEST;

    for (size_t i = 0; i < end_candidates.size(); ++i) {
      const SearchPath& sp = end_candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.path == end_candidates[i - 1].path) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.search.empty()) {
        joint_empty_end = add_log(joint_empty_end, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) {
        joint_end = add_log(joint_end, score_sum * SCORE_LOG_BASE);
      }
      ++num_unique_end;
      end_max_left_softclip =
          std::max(end_max_left_softclip, sp.read_stats.back().left_softclip);
      for (int64_t node : sp.path) end_node_counts[node] += 1;
      end_start_node_index[sp.path.front()].push_back(static_cast<uint32_t>(i));
    }

    bool end_alignment_in_cycle = false;
    for (const auto& [node, indices] : end_start_node_index) {
      if (node >= 0 && node <= idx_.max_enc_node && idx_.node_in_cycle[node]) {
        end_alignment_in_cycle = true;
        break;
      }
    }

    std::vector<std::pair<SearchPath, bool>> stack;
    double joint_start = LOWEST, joint_empty_start = LOWEST;

    for (size_t i = 0; i < start_candidates.size(); ++i) {
      const SearchPath& sp = start_candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.path == start_candidates[i - 1].path) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.search.empty()) {
        joint_empty_start = add_log(joint_empty_start, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) {
        joint_start = add_log(joint_start, score_sum * SCORE_LOG_BASE);
      }

      int32_t node_length = idx_.node_length(sp.search.node >> 1);

      for (const auto& [end_start_node, end_indices] : end_start_node_index) {
        for (size_t pos = 0; pos < sp.path.size(); ++pos) {
          if (sp.path[pos] != end_start_node) continue;
          for (uint32_t end_idx : end_indices) {
            SearchPath merged = sp;
            merge_paired(&merged, pos, end_candidates[end_idx]);
            if (!merged.search.empty() &&
                merged.fragment_length() <= p_.max_pair_frag_length) {
              out->push_back(std::move(merged));
            }
          }
        }
      }

      SearchPath extended = sp;
      extended.insert_length += node_length - sp.end_offset;
      extended.end_offset = node_length;
      stack.push_back({std::move(extended), false});
    }

    // DFS over panel out-edges, backtracking IN PLACE on one working
    // SearchPath (the copy-per-pushed-edge formulation dominated the
    // fragment pass: 3-4 vector allocations per explored node).  The
    // explicit-stack version popped LIFO, so seeds and edges recurse in
    // REVERSE order here to emit the same output sequence.
    // Iterative DFS over panel out-edges, backtracking IN PLACE on one
    // working SearchPath with heap-allocated frames (depth is bounded
    // only by max_pair_frag_length in graph nodes — a long-fragment
    // library over 1-bp nodes must not recurse the thread stack away).
    // Frames recurse seeds and edges in REVERSE so the emission order
    // matches the original explicit-stack formulation exactly.
    //
    // visit(): completions + prune checks; returns true when the node
    // should expand its out-edges (and then fills *blocked_out).
    auto visit = [&](SearchPath& cur, bool try_complete,
                     int64_t* blocked_out) -> bool {
      if (try_complete) {
        auto it = end_start_node_index.find(cur.path.back());
        if (it != end_start_node_index.end()) {
          for (uint32_t end_idx : it->second) {
            SearchPath merged = cur;
            merged.insert_length -= merged.end_offset;
            merged.end_offset = end_candidates[end_idx].start_offset;
            merged.insert_length += merged.end_offset;
            merge_paired(&merged, cur.path.size() - 1, end_candidates[end_idx]);
            if (!merged.search.empty() &&
                merged.fragment_length() <= p_.max_pair_frag_length) {
              out->push_back(std::move(merged));
            }
          }
        }
      }

      if (!end_alignment_in_cycle) {
        auto it = end_node_counts.find(cur.path.back());
        if (it != end_node_counts.end() && it->second == num_unique_end) {
          return false;
        }
      }

      if (cur.fragment_length() + end_seq_length - end_max_left_softclip >
          p_.max_pair_frag_length) {
        return false;
      }

      *blocked_out = cur.read_stats.back().internal_end_next_node;
      return true;
    };

    struct DfsFrame {
      int64_t e;           // next edge to try (counting down)
      int64_t edge_begin;
      int64_t blocked;     // this node's blocked successor
      // Undo info for THIS node's entry (unused on the seed frame).
      int32_t saved_end_offset = 0;
      int64_t saved_node = 0;
      int64_t saved_blocked = 0;
    };
    std::vector<DfsFrame> frames;
    for (size_t s = stack.size(); s-- > 0;) {
      SearchPath& cur = stack[s].first;
      int64_t blocked;
      if (!visit(cur, stack[s].second, &blocked)) continue;
      frames.clear();
      frames.push_back({idx_.edge_offsets[cur.search.node + 1] - 1,
                        idx_.edge_offsets[cur.search.node], blocked});
      while (!frames.empty()) {
        const size_t depth = frames.size() - 1;
        DfsFrame& f = frames.back();
        if (f.e < f.edge_begin) {
          // Out of edges: undo this node's entry (seed frame owns no
          // entry) and pop.
          if (depth > 0) {
            cur.read_stats.back().internal_end_next_node = f.saved_blocked;
            cur.insert_length -= cur.end_offset;
            cur.end_offset = f.saved_end_offset;
            cur.path.pop_back();
            cur.search.node = f.saved_node;
            std::swap(cur.search.positions, depth_scratch_[depth - 1]);
          }
          frames.pop_back();
          continue;
        }
        const int64_t succ = idx_.edge_targets[f.e--];
        if (succ == ENDMARKER || succ == f.blocked) continue;
        if (depth_scratch_.size() <= depth) depth_scratch_.resize(depth + 1);
        index_extend_into(idx_, cur.search.positions, succ,
                          &depth_scratch_[depth]);
        if (depth_scratch_[depth].empty()) continue;
        // Descend in place; the child frame carries the undo info.
        DfsFrame child;
        child.saved_end_offset = cur.end_offset;
        child.saved_node = cur.search.node;
        child.saved_blocked = f.blocked;
        std::swap(cur.search.positions, depth_scratch_[depth]);
        cur.search.node = succ;
        cur.path.push_back(succ);
        cur.end_offset = idx_.node_length(succ >> 1);
        cur.insert_length += cur.end_offset;
        cur.read_stats.back().internal_end_next_node = ENDMARKER;
        int64_t child_blocked;
        if (visit(cur, true, &child_blocked)) {
          child.e = idx_.edge_offsets[succ + 1] - 1;
          child.edge_begin = idx_.edge_offsets[succ];
          child.blocked = child_blocked;
          frames.push_back(child);  // f may dangle after this push
        } else {
          // Pruned: undo immediately.
          cur.read_stats.back().internal_end_next_node = child.saved_blocked;
          cur.insert_length -= cur.end_offset;
          cur.end_offset = child.saved_end_offset;
          cur.path.pop_back();
          cur.search.node = child.saved_node;
          std::swap(cur.search.positions, depth_scratch_[depth]);
        }
      }
    }
    stack.clear();

    SearchPath noise;
    AlignmentStats stats_1;
    stats_1.score =
        double_to_int((joint_start - joint_empty_start) / NOISE_SCORE_LOG_BASE);
    AlignmentStats stats_2;
    stats_2.score = double_to_int((joint_end - joint_empty_end) / NOISE_SCORE_LOG_BASE);
    noise.read_stats = {stats_1, stats_2};
    out->push_back(std::move(noise));
  }


  void merge_paired(SearchPath* main, size_t main_start_idx,
                    const SearchPath& second) const {
    if (second.path.size() < main->path.size() - main_start_idx) {
      main->clear();
      return;
    }

    const AlignmentStats& main_stats = main->read_stats.back();
    const AlignmentStats& second_stats = second.read_stats.front();

    if (main_start_idx == 0) {
      int32_t main_left = main->start_offset - main_stats.clipped_left();
      int32_t second_left = second.start_offset - second_stats.clipped_left();
      if (second_left < main_left) {
        main->clear();
        return;
      }
    }

    size_t second_idx = 0;
    size_t idx = main_start_idx;
    size_t n_main = main->path.size();

    while (idx < n_main) {
      if (main->path[idx] != second.path[second_idx]) {
        main->clear();
        return;
      }

      if (idx + 1 == n_main) {
        if (second_idx + 1 == second.path.size()) {
          int32_t main_right = main->end_offset + main_stats.clipped_right();
          int32_t second_right = second.end_offset + second_stats.clipped_right();
          if (second_right < main_right) {
            main->clear();
            return;
          }
          if (idx == 0) {
            main->insert_length +=
                std::max(main->start_offset, second.start_offset) -
                std::min(main->end_offset, second.end_offset);
          } else if (second_idx == 0) {
            main->insert_length += second.start_offset -
                                   std::min(main->end_offset, second.end_offset);
          } else {
            main->insert_length -= std::min(main->end_offset, second.end_offset);
          }
        } else if (second_idx == 0) {
          main->insert_length += second.start_offset - main->end_offset;
        } else {
          main->insert_length -= main->end_offset;
        }
      } else if (second_idx == 0) {
        int32_t node_length = idx_.node_length(main->path[idx] >> 1);
        if (idx == 0) {
          main->insert_length -=
              node_length - std::max(main->start_offset, second.start_offset);
        } else {
          main->insert_length -= node_length - second.start_offset;
        }
      } else {
        main->insert_length -= idx_.node_length(main->path[idx] >> 1);
      }

      ++idx;
      ++second_idx;
    }

    main->end_offset = second.end_offset;
    main->read_stats.push_back(second.read_stats.front());

    while (second_idx < second.path.size()) {
      main->path.push_back(second.path[second_idx]);
      index_extend(idx_, &main->search, main->path.back());
      if (main->search.empty()) break;
      ++second_idx;
    }
  }

  // -------------------------------------------------------------- misc
  bool below_best_score_filter(const std::vector<SearchPath>& paths,
                               const std::vector<int32_t>& optimal) const {
    double best = 0.0;
    for (const auto& sp : paths) {
      if (sp.is_complete()) {
        best = std::max(best, sp.min_optimal_score_fraction(optimal));
      }
    }
    return best < p_.min_best_score_filter;
  }

  static SearchPath make_error_sentinel(int32_t seq_length) {
    SearchPath sentinel;
    sentinel.path.push_back(ENDMARKER);
    AlignmentStats stats;
    stats.score = INT32_MAX_V;
    stats.length = seq_length;
    stats.complete = true;
    sentinel.read_stats.push_back(stats);
    return sentinel;
  }

  std::vector<AlignmentPathOut> finalize(std::vector<SearchPath>& search_paths,
                                         bool is_multimap, int32_t mapq) const {
    if (search_paths.empty()) return {};

    bool is_simple = !is_multimap;
    if (is_simple) {
      int32_t frag_length = 0;
      for (const auto& sp : search_paths) {
        if (sp.is_complete()) {
          if (sp.is_internal() ||
              (frag_length > 0 && sp.fragment_length() != frag_length)) {
            is_simple = false;
            break;
          }
          frag_length = sp.fragment_length();
        }
      }
    }

    std::vector<AlignmentPathOut> align_paths;
    double noise_prob = 1.0;

    for (auto& sp : search_paths) {
      if (sp.search.empty()) {
        double non_noise_prob = 1.0;
        for (const auto& stats : sp.read_stats) {
          double read_error_prob =
              1.0 / (1.0 + std::exp(stats.score * NOISE_SCORE_LOG_BASE));
          non_noise_prob *= 1.0 - read_error_prob;
        }
        noise_prob = std::min(noise_prob, 1.0 - non_noise_prob);
      } else if (sp.is_complete()) {
        AlignmentPathOut out;
        out.search = std::move(sp.search);
        out.is_simple = is_simple;
        out.mapq = mapq;
        out.score_sum = sp.score_sum();
        out.align_length = sp.alignment_length();
        out.frag_length = sp.fragment_length();
        align_paths.push_back(std::move(out));
      }
    }

    std::sort(align_paths.begin(), align_paths.end(),
              [](const AlignmentPathOut& a, const AlignmentPathOut& b) {
                if (a.search.node != b.search.node) return a.search.node > b.search.node;
                if (a.search.positions != b.search.positions)
                  return a.search.positions > b.search.positions;
                if (a.is_simple != b.is_simple) return a.is_simple > b.is_simple;
                if (a.mapq != b.mapq) return a.mapq > b.mapq;
                if (a.frag_length != b.frag_length) return a.frag_length > b.frag_length;
                if (a.align_length != b.align_length)
                  return a.align_length > b.align_length;
                return a.score_sum > b.score_sum;
              });

    if (!align_paths.empty()) {
      AlignmentPathOut noise;
      noise.is_simple = is_simple;
      noise.mapq = mapq;
      noise.align_length = 0;
      noise.frag_length = 0;
      const double eps = std::numeric_limits<double>::epsilon() * 100;
      bool is_zero = noise_prob == 0.0 ||
                     std::abs(noise_prob - 0.0) <
                         std::abs(std::min(noise_prob, 0.0)) * eps;
      if (is_zero) {
        noise.score_sum = INT32_MIN_V;
      } else {
        noise.score_sum = double_to_int(std::log(noise_prob) / NOISE_SCORE_LOG_BASE);
      }
      align_paths.push_back(std::move(noise));
    }
    return align_paths;
  }
};

// ---------------------------------------------------------- serialization

struct Reader {
  const uint8_t* ptr;
  const uint8_t* end;

  template <typename T>
  T get() {
    T value;
    std::memcpy(&value, ptr, sizeof(T));
    ptr += sizeof(T);
    return value;
  }
};

PathRec read_path(Reader* r) {
  PathRec path;
  int32_t n_mappings = r->get<int32_t>();
  path.mappings.resize(n_mappings);
  for (auto& m : path.mappings) {
    m.node = r->get<int64_t>();
    m.offset = r->get<int32_t>();
    m.to_length = r->get<int32_t>();
    m.from_length = r->get<int32_t>();
    m.first_edit_from = r->get<int32_t>();
    m.first_edit_to = r->get<int32_t>();
    m.last_edit_from = r->get<int32_t>();
    m.last_edit_to = r->get<int32_t>();
  }
  return path;
}

AlignmentRec read_alignment(Reader* r, bool is_multipath) {
  AlignmentRec aln;
  aln.is_multipath = is_multipath;
  aln.seq_len = r->get<int32_t>();
  aln.mapq = r->get<int32_t>();
  aln.allelic_mapq = r->get<int32_t>();
  aln.disconnected = r->get<uint8_t>() != 0;
  uint8_t has_quality = r->get<uint8_t>();
  if (has_quality) {
    aln.quality.resize(aln.seq_len);
    std::memcpy(aln.quality.data(), r->ptr, aln.seq_len);
    r->ptr += aln.seq_len;
  }
  if (!is_multipath) {
    aln.score = r->get<int32_t>();
    aln.path = read_path(r);
  } else {
    int32_t n_subpaths = r->get<int32_t>();
    int32_t n_starts = r->get<int32_t>();
    aln.starts.resize(n_starts);
    for (auto& s : aln.starts) s = r->get<int32_t>();
    aln.subpaths.resize(n_subpaths);
    for (auto& sp : aln.subpaths) {
      sp.score = r->get<int32_t>();
      sp.n_connections = r->get<int32_t>();
      int32_t n_next = r->get<int32_t>();
      sp.next.resize(n_next);
      for (auto& n : sp.next) n = r->get<int32_t>();
      sp.path = read_path(r);
    }
  }
  return aln;
}

struct Writer {
  std::vector<uint8_t> buf;

  template <typename T>
  void put(T value) {
    size_t offset = buf.size();
    buf.resize(offset + sizeof(T));
    std::memcpy(buf.data() + offset, &value, sizeof(T));
  }
};

void skip_path(Reader* r) {
  int32_t n_mappings = r->get<int32_t>();
  r->ptr += n_mappings * (8 + 7 * 4);
}

void skip_alignment(Reader* r, bool is_multipath) {
  int32_t seq_len = r->get<int32_t>();
  r->ptr += 8;  // mapq + allelic_mapq
  r->ptr += 1;  // disconnected
  uint8_t has_quality = r->get<uint8_t>();
  if (has_quality) r->ptr += seq_len;
  if (!is_multipath) {
    r->ptr += 4;  // score
    skip_path(r);
  } else {
    int32_t n_subpaths = r->get<int32_t>();
    int32_t n_starts = r->get<int32_t>();
    r->ptr += n_starts * 4;
    for (int32_t i = 0; i < n_subpaths; ++i) {
      r->ptr += 8;  // score + n_connections
      int32_t n_next = r->get<int32_t>();
      r->ptr += n_next * 4;
      skip_path(r);
    }
  }
}

void write_results(Writer* w, const std::vector<AlignmentPathOut>& paths) {
  w->put<int32_t>(static_cast<int32_t>(paths.size()));
  for (const auto& ap : paths) {
    w->put<int64_t>(ap.search.node);
    w->put<int32_t>(static_cast<int32_t>(ap.search.positions.size()));
    for (int64_t pos : ap.search.positions) w->put<int64_t>(pos);
    w->put<uint8_t>(ap.is_simple ? 1 : 0);
    w->put<int32_t>(ap.mapq);
    w->put<int32_t>(ap.score_sum);
    w->put<int32_t>(ap.align_length);
    w->put<int32_t>(ap.frag_length);
  }
}

}  // namespace

// ------------------------------------------------------------------ C ABI

extern "C" {

void* rpvg_index_create(const int64_t* concat, int64_t concat_len,
                        const int64_t* seq_starts, int64_t n_seqs,
                        const int32_t* node_lengths, int64_t n_nodes,
                        int32_t bidirectional) {
  auto* idx = new Index();
  idx->concat.assign(concat, concat + concat_len);
  idx->seq_starts.assign(seq_starts, seq_starts + n_seqs);
  idx->node_lengths.assign(node_lengths, node_lengths + n_nodes);
  idx->bidirectional = bidirectional != 0;

  int64_t max_node = 0;
  for (int64_t v : idx->concat) max_node = std::max(max_node, v);
  idx->max_enc_node = max_node;

  // Occurrence CSR (counting sort).
  std::vector<int64_t> counts(max_node + 2, 0);
  for (int64_t i = 0; i < concat_len; ++i) {
    if (idx->concat[i] != ENDMARKER) counts[idx->concat[i] + 1]++;
  }
  idx->occ_offsets.resize(max_node + 2);
  idx->occ_offsets[0] = 0;
  for (int64_t v = 0; v <= max_node; ++v) {
    idx->occ_offsets[v + 1] = idx->occ_offsets[v] + counts[v + 1];
  }
  idx->occ_positions.resize(idx->occ_offsets[max_node + 1]);
  std::vector<int64_t> cursor(idx->occ_offsets.begin(), idx->occ_offsets.end() - 1);
  for (int64_t i = 0; i < concat_len; ++i) {
    int64_t node = idx->concat[i];
    if (node != ENDMARKER) idx->occ_positions[cursor[node]++] = i;
  }

  // Distinct successor lists per node.
  idx->edge_offsets.assign(max_node + 2, 0);
  std::vector<std::vector<int64_t>> succ(max_node + 1);
  for (int64_t v = 1; v <= max_node; ++v) {
    int64_t begin = idx->occ_offsets[v], end = idx->occ_offsets[v + 1];
    if (begin == end) continue;
    std::vector<int64_t>& targets = succ[v];
    for (int64_t i = begin; i < end; ++i) {
      targets.push_back(idx->concat[idx->occ_positions[i] + 1]);
    }
    std::sort(targets.begin(), targets.end());
    targets.erase(std::unique(targets.begin(), targets.end()), targets.end());
  }
  for (int64_t v = 0; v <= max_node; ++v) {
    idx->edge_offsets[v + 1] =
        idx->edge_offsets[v] + static_cast<int64_t>(succ[v].size());
  }
  idx->edge_targets.resize(idx->edge_offsets[max_node + 1]);
  for (int64_t v = 0; v <= max_node; ++v) {
    std::copy(succ[v].begin(), succ[v].end(),
              idx->edge_targets.begin() + idx->edge_offsets[v]);
  }

  // Cycle table: node v is cyclic iff one sequence visits it twice —
  // exactly `num_located(find(v)) < find(v).size()`, which the paired
  // DFS otherwise recomputes per fragment with per-position binary
  // searches.  One linear pass over the concat at build time.
  idx->node_in_cycle.assign(max_node + 1, 0);
  {
    std::vector<int64_t> last_seq(max_node + 1, -1);
    int64_t seq = -1;
    int64_t next_start = 0;
    for (int64_t i = 0; i < concat_len; ++i) {
      while (next_start < n_seqs && seq_starts[next_start] <= i) {
        ++seq;
        ++next_start;
      }
      const int64_t node = idx->concat[i];
      if (node == ENDMARKER) continue;
      if (last_seq[node] == seq) {
        idx->node_in_cycle[node] = 1;
      } else {
        last_seq[node] = seq;
      }
    }
  }
  return idx;
}

void rpvg_index_free(void* handle) { delete static_cast<Index*>(handle); }

// params layout (int32 x 7 + double): library_type, score_not_qual,
// max_pair_frag_length, max_partial_offset, est_missing_noise_prob,
// max_score_diff, use_allelic_mapq, min_best_score_filter.
uint8_t* rpvg_project_batch(void* handle, const uint8_t* input, int64_t input_len,
                            const int32_t* iparams, double min_best_score_filter,
                            const int32_t* qual_match_scores,
                            const int32_t* qual_bonuses, int64_t* out_len) {
  const Index& idx = *static_cast<Index*>(handle);
  Params params;
  params.library_type = iparams[0];
  params.score_not_qual = iparams[1];
  params.max_pair_frag_length = iparams[2];
  params.max_partial_offset = iparams[3];
  params.est_missing_noise_prob = iparams[4];
  params.max_score_diff = iparams[5];
  params.use_allelic_mapq = iparams[6];
  params.min_best_score_filter = min_best_score_filter;

  ScoreTables tables;
  for (int i = 0; i < 256; ++i) {
    tables.match_scores[i] = qual_match_scores[i];
    tables.bonuses[i] = qual_bonuses[i];
  }

  int32_t n_threads = std::max(1, iparams[7]);

  // Locate per-fragment record offsets with a cheap skip scan so the
  // batch can be partitioned across worker threads.
  Reader scan{input, input + input_len};
  int32_t n_fragments = scan.get<int32_t>();
  std::vector<const uint8_t*> offsets(n_fragments + 1);
  for (int32_t f = 0; f < n_fragments; ++f) {
    offsets[f] = scan.ptr;
    uint8_t kind = scan.get<uint8_t>();
    skip_alignment(&scan, kind & 1);
    if (kind & 2) skip_alignment(&scan, kind & 1);
  }
  offsets[n_fragments] = scan.ptr;

  auto process_range = [&](int32_t begin, int32_t end, Writer* writer) {
    Finder finder(idx, params, tables);
    Reader reader{offsets[begin], input + input_len};
    for (int32_t f = begin; f < end; ++f) {
      uint8_t kind = reader.get<uint8_t>();
      bool is_multipath = kind & 1;
      bool is_paired = kind & 2;
      AlignmentRec aln_1 = read_alignment(&reader, is_multipath);
      if (is_paired) {
        AlignmentRec aln_2 = read_alignment(&reader, is_multipath);
        write_results(writer, finder.find_paired(aln_1, aln_2));
      } else {
        write_results(writer, finder.find_single(aln_1));
      }
    }
  };

  n_threads = std::min<int32_t>(n_threads, std::max(1, n_fragments));
  std::vector<Writer> writers(n_threads);
  if (n_threads == 1) {
    process_range(0, n_fragments, &writers[0]);
  } else {
    std::vector<std::thread> workers;
    for (int32_t t = 0; t < n_threads; ++t) {
      int32_t begin = static_cast<int32_t>(
          static_cast<int64_t>(n_fragments) * t / n_threads);
      int32_t end = static_cast<int32_t>(
          static_cast<int64_t>(n_fragments) * (t + 1) / n_threads);
      workers.emplace_back(process_range, begin, end, &writers[t]);
    }
    for (auto& w : workers) w.join();
  }

  size_t total = sizeof(int32_t);
  for (const auto& w : writers) total += w.buf.size();
  auto* out = static_cast<uint8_t*>(std::malloc(total));
  std::memcpy(out, &n_fragments, sizeof(int32_t));
  size_t pos = sizeof(int32_t);
  for (const auto& w : writers) {
    std::memcpy(out + pos, w.buf.data(), w.buf.size());
    pos += w.buf.size();
  }
  *out_len = static_cast<int64_t>(total);
  return out;
}

void rpvg_buffer_free(uint8_t* buf) { std::free(buf); }

}  // extern "C"

// --------------------------------------------------------- fragment index
//
// Native twin of the Python FragmentIndex (pipeline.py): per-fragment
// results are condensed, histogrammed, normalised (2-element rewrite)
// and deduplicated entirely in C++; Python parses only the distinct
// lists once at the end of the pass.

namespace {

// Dedup map value: occurrence count + the GLOBAL ordinal of the
// fragment that first produced this list.  Dumps order entries by
// `ord`, which is the single-threaded stream's first-seen order — a
// canonical order independent of thread count AND of which worker
// happened to process a fragment, so the projection loop is free to
// work-steal (static range splits stalled every block's join barrier
// on its slowest slice; multimapping cost is heavy-tailed).
struct EntryVal {
  uint64_t count = 0;
  uint64_t ord = ~0ull;
};

struct NativeFragmentIndex {
  std::unordered_map<std::string, EntryVal> entries;
  // RPVG_TPU_NATIVE_PROF=1 sub-phase thread-CPU accounting (ns).
  std::atomic<uint64_t> prof_project_ns{0};
  std::atomic<uint64_t> prof_dedup_ns{0};
  // Per-worker dedup maps: workers accumulate across every projected
  // block and merge ONCE at dump time — the per-block merge re-hashed
  // every fragment's key into the global map and dominated the
  // fragment pass at scale.  Which worker holds an entry is
  // schedule-dependent; the ordinal in EntryVal restores the canonical
  // order at dump.
  std::vector<std::unordered_map<std::string, EntryVal>> worker_entries;
  std::vector<int64_t> histogram;
  int32_t pre_loc = 0;
  int32_t is_single_end = 0;
  uint64_t unaligned = 0;
  uint64_t next_ordinal = 0;  // advanced per block by the serial caller

  void merge_workers() {
    for (auto& local : worker_entries) {
      for (auto& [key, val] : local) {
        EntryVal& dst = entries[key];
        dst.count += val.count;
        dst.ord = std::min(dst.ord, val.ord);
      }
      local.clear();
    }
    worker_entries.clear();
  }
};

constexpr int32_t FRAG_LENGTH_MIN_MAPQ = 30;

void serialize_path_list(Writer* w, const std::vector<AlignmentPathOut>& paths) {
  for (const auto& ap : paths) {
    w->put<int64_t>(ap.search.node);
    w->put<int32_t>(static_cast<int32_t>(ap.search.positions.size()));
    for (int64_t pos : ap.search.positions) w->put<int64_t>(pos);
    w->put<uint8_t>(ap.is_simple ? 1 : 0);
    w->put<int32_t>(ap.mapq);
    w->put<int32_t>(ap.score_sum);
    w->put<int32_t>(ap.align_length);
    w->put<int32_t>(ap.frag_length);
  }
}

void index_fragment(NativeFragmentIndex* fidx,
                    std::unordered_map<std::string, EntryVal>* entries,
                    std::vector<AlignmentPathOut>&& paths,
                    uint64_t ordinal) {
  if (paths.empty()) {
    ++fidx->unaligned;
    return;
  }

  // Condense: drop consecutive entries with identical (search state,
  // fragment length), keeping the first (pipeline.condense_alignment_paths).
  if (paths.size() > 2) {
    std::vector<AlignmentPathOut> condensed;
    condensed.reserve(paths.size());
    condensed.push_back(std::move(paths.front()));
    for (size_t i = 1; i < paths.size(); ++i) {
      const AlignmentPathOut& prev = condensed.back();
      AlignmentPathOut& cur = paths[i];
      if (prev.search.node == cur.search.node &&
          prev.search.positions == cur.search.positions &&
          prev.frag_length == cur.frag_length) {
        continue;
      }
      condensed.push_back(std::move(cur));
    }
    paths = std::move(condensed);
  }

  AlignmentPathOut& first = paths.front();
  if (!fidx->is_single_end && first.is_simple &&
      first.mapq >= FRAG_LENGTH_MIN_MAPQ &&
      first.frag_length < static_cast<int32_t>(fidx->histogram.size())) {
    fidx->histogram[first.frag_length] += 1;
  }

  if (paths.size() == 2) {
    first.score_sum = 1;
    first.align_length = 1;
    first.frag_length = fidx->pre_loc;
  }

  Writer key_writer;
  key_writer.put<int32_t>(static_cast<int32_t>(paths.size()));
  serialize_path_list(&key_writer, paths);
  std::string key(reinterpret_cast<const char*>(key_writer.buf.data()),
                  key_writer.buf.size());
  EntryVal& val = (*entries)[key];
  val.count += 1;
  val.ord = std::min(val.ord, ordinal);
}

}  // namespace

extern "C" {

void* rpvg_indexer_create(int64_t hist_size, int32_t pre_loc, int32_t is_single_end) {
  auto* idx = new NativeFragmentIndex();
  idx->histogram.assign(hist_size, 0);
  idx->pre_loc = pre_loc;
  idx->is_single_end = is_single_end;
  return idx;
}

void rpvg_indexer_free(void* handle) {
  auto* fidx = static_cast<NativeFragmentIndex*>(handle);
  const uint64_t proj = fidx->prof_project_ns.load();
  const uint64_t dedup = fidx->prof_dedup_ns.load();
  if (proj + dedup) {
    std::fprintf(stderr,
                 "  [native-prof] fragment pass thread-CPU: projection "
                 "%.3fs (extend %.3fs, pair %.3fs), dedup %.3fs; "
                 "serial prescan wall %.3fs\n",
                 proj * 1e-9, g_prof_extend_ns.exchange(0) * 1e-9,
                 g_prof_pair_ns.exchange(0) * 1e-9, dedup * 1e-9,
                 g_prof_prescan_ns.exchange(0) * 1e-9);
  }
  delete fidx;
}

// Project a batch and fold the results straight into the native
// fragment index (no per-fragment Python round trip).
void rpvg_project_and_index(void* handle, void* indexer, const uint8_t* input,
                            int64_t input_len, const int32_t* iparams,
                            double min_best_score_filter,
                            const int32_t* qual_match_scores,
                            const int32_t* qual_bonuses) {
  const Index& idx = *static_cast<Index*>(handle);
  auto* fidx = static_cast<NativeFragmentIndex*>(indexer);

  Params params;
  params.library_type = iparams[0];
  params.score_not_qual = iparams[1];
  params.max_pair_frag_length = iparams[2];
  params.max_partial_offset = iparams[3];
  params.est_missing_noise_prob = iparams[4];
  params.max_score_diff = iparams[5];
  params.use_allelic_mapq = iparams[6];
  params.min_best_score_filter = min_best_score_filter;
  int32_t n_threads = std::max(1, iparams[7]);

  ScoreTables tables;
  for (int i = 0; i < 256; ++i) {
    tables.match_scores[i] = qual_match_scores[i];
    tables.bonuses[i] = qual_bonuses[i];
  }

  const uint64_t prescan_t0 = prof_on() ? prof_wall() : 0;
  Reader scan{input, input + input_len};
  int32_t n_fragments = scan.get<int32_t>();
  std::vector<const uint8_t*> offsets(n_fragments + 1);
  for (int32_t f = 0; f < n_fragments; ++f) {
    offsets[f] = scan.ptr;
    uint8_t kind = scan.get<uint8_t>();
    skip_alignment(&scan, kind & 1);
    if (kind & 2) skip_alignment(&scan, kind & 1);
  }
  offsets[n_fragments] = scan.ptr;
  if (prof_on()) {
    g_prof_prescan_ns.fetch_add(prof_wall() - prescan_t0,
                                std::memory_order_relaxed);
  }

  n_threads = std::min<int32_t>(n_threads, std::max(1, n_fragments));
  // Dedup maps persist across blocks on the indexer (merged once at
  // dump); only per-block histogram/unaligned counters are local.
  if (static_cast<int32_t>(fidx->worker_entries.size()) < n_threads) {
    fidx->worker_entries.resize(n_threads);
    for (auto& local : fidx->worker_entries) {
      // Pre-size for a large run's per-worker distinct-fragment count
      // (rehashing re-hashes every key; 1<<16 buckets cost ~0.5MB).
      local.reserve(1 << 16);
    }
  }
  std::vector<NativeFragmentIndex> locals(n_threads);
  for (auto& l : locals) {
    l.histogram.assign(fidx->histogram.size(), 0);
    l.pre_loc = fidx->pre_loc;
    l.is_single_end = fidx->is_single_end;
  }

  const bool prof_enabled = prof_on();
  auto thread_ns = prof_now;
  const uint64_t ord_base = fidx->next_ordinal;
  fidx->next_ordinal += static_cast<uint64_t>(n_fragments);

  auto process_range = [&](int32_t begin, int32_t end, NativeFragmentIndex* local,
                           std::unordered_map<std::string, EntryVal>* entries,
                           Finder* finder) {
    Reader reader{offsets[begin], offsets[end]};
    uint64_t project_ns = 0, dedup_ns = 0, t0 = 0;
    for (int32_t f = begin; f < end; ++f) {
      const uint64_t ord = ord_base + static_cast<uint64_t>(f);
      uint8_t kind = reader.get<uint8_t>();
      bool is_multipath = kind & 1;
      bool is_paired = kind & 2;
      AlignmentRec aln_1 = read_alignment(&reader, is_multipath);
      if (prof_enabled) t0 = thread_ns();
      if (is_paired) {
        AlignmentRec aln_2 = read_alignment(&reader, is_multipath);
        auto found = finder->find_paired(aln_1, aln_2);
        if (prof_enabled) {
          uint64_t t1 = thread_ns();
          project_ns += t1 - t0;
          index_fragment(local, entries, std::move(found), ord);
          dedup_ns += thread_ns() - t1;
        } else {
          index_fragment(local, entries, std::move(found), ord);
        }
      } else {
        auto found = finder->find_single(aln_1);
        if (prof_enabled) {
          uint64_t t1 = thread_ns();
          project_ns += t1 - t0;
          index_fragment(local, entries, std::move(found), ord);
          dedup_ns += thread_ns() - t1;
        } else {
          index_fragment(local, entries, std::move(found), ord);
        }
      }
    }
    if (prof_enabled) {
      fidx->prof_project_ns.fetch_add(project_ns, std::memory_order_relaxed);
      fidx->prof_dedup_ns.fetch_add(dedup_ns, std::memory_order_relaxed);
    }
  };

  if (n_threads == 1) {
    Finder finder(idx, params, tables);
    process_range(0, n_fragments, &locals[0], &fidx->worker_entries[0],
                  &finder);
  } else {
    // Chunked work-stealing: multimapping cost is heavy-tailed (a
    // fragment hitting a giant cluster runs a deep DFS), so static
    // range splits stall the per-block join barrier on the slowest
    // slice.  Entry ordinals (not worker identity) carry the canonical
    // order, so any thread may take any chunk.
    constexpr int32_t kStealChunk = 64;
    std::atomic<int32_t> cursor{0};
    auto steal_loop = [&](int32_t t) {
      Finder finder(idx, params, tables);
      for (;;) {
        const int32_t begin = cursor.fetch_add(kStealChunk);
        if (begin >= n_fragments) return;
        const int32_t end = std::min(n_fragments, begin + kStealChunk);
        process_range(begin, end, &locals[t], &fidx->worker_entries[t],
                      &finder);
      }
    };
    std::vector<std::thread> workers;
    workers.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) workers.emplace_back(steal_loop, t);
    for (auto& w : workers) w.join();
  }

  for (auto& local : locals) {
    for (size_t i = 0; i < local.histogram.size(); ++i) {
      fidx->histogram[i] += local.histogram[i];
    }
    fidx->unaligned += local.unaligned;
  }
}

}  // extern "C"

// ----------------------------------------------------- cluster probs
//
// Native twin of ReadPathProbs.add_path_probs + the per-cluster sort /
// identical-row merge (rpvg_tpu/probabilities.py; reference
// src/read_path_probabilities.cpp) operating directly on serialized
// alignment-path lists.

namespace {

struct RppRow {
  uint64_t read_count;
  double noise_prob;
  std::vector<std::pair<double, std::vector<int32_t>>> path_probs;
};

void locate_path_ids(const Index& idx, const int64_t* positions, int32_t n_pos,
                     std::vector<int64_t>* out) {
  out->clear();
  int64_t prev = -1;
  for (int32_t i = 0; i < n_pos; ++i) {
    auto it = std::upper_bound(idx.seq_starts.begin(), idx.seq_starts.end(),
                               positions[i]);
    int64_t seq = (it - idx.seq_starts.begin()) - 1;
    if (seq != prev) {
      out->push_back(idx.bidirectional ? seq / 2 : seq);
      prev = seq;
    }
  }
}

bool rpp_row_less(const RppRow& a, const RppRow& b) {
  if (a.noise_prob != b.noise_prob) return a.noise_prob < b.noise_prob;
  if (a.path_probs.size() != b.path_probs.size())
    return a.path_probs.size() < b.path_probs.size();
  for (size_t i = 0; i < a.path_probs.size(); ++i) {
    if (a.path_probs[i].first != b.path_probs[i].first)
      return a.path_probs[i].first < b.path_probs[i].first;
    if (a.path_probs[i].second.size() != b.path_probs[i].second.size())
      return a.path_probs[i].second.size() < b.path_probs[i].second.size();
    for (size_t j = 0; j < a.path_probs[i].second.size(); ++j) {
      if (a.path_probs[i].second[j] != b.path_probs[i].second[j])
        return a.path_probs[i].second[j] < b.path_probs[i].second[j];
    }
  }
  return a.read_count < b.read_count;
}

bool rpp_merge_identical(RppRow* into, const RppRow& other, double precision) {
  if (std::abs(into->noise_prob - other.noise_prob) >= precision) return false;
  if (into->path_probs.size() != other.path_probs.size()) return false;
  for (size_t i = 0; i < into->path_probs.size(); ++i) {
    if (std::abs(into->path_probs[i].first - other.path_probs[i].first) >= precision)
      return false;
    if (into->path_probs[i].second != other.path_probs[i].second) return false;
  }
  into->read_count += other.read_count;
  return true;
}

}  // namespace

extern "C" {

// Build merged read-path probability rows for one cluster.
//
// entries: serialized alignment-path lists, each prefixed by u64 count
//   (the exact bytes the indexer dump emits per entry).
// cluster_path_ids: sorted global path ids of this cluster.
// eff_lengths: per local path (cluster order) effective length.
// group_of: per local path collapse-group index (or -1s when group
//   collapse is off); n_groups: number of groups.
// log_source_counts: per local path log(source_count).
// frag_log_probs: fragment-length log-probability table.
// Returns malloc'd buffer: u64 n_rows, per row: u64 count, f64 noise,
// i32 n_entries, per entry: f64 prob, i32 n_ids, i32 ids...
uint8_t* rpvg_build_cluster_probs(
    void* handle, const uint8_t* entries, int64_t entries_len, int64_t n_entries,
    const int64_t* cluster_path_ids, int64_t n_paths,
    const double* eff_lengths, const int32_t* group_of, int64_t n_groups,
    const double* log_source_counts, const double* frag_log_probs,
    int64_t frag_table_size, int32_t is_single_end, double min_noise_prob,
    double prob_precision, int64_t* out_len);

}  // extern "C"

namespace {

// Core of the per-cluster probability construction: parse serialized
// entries, compute ReadPathProbs rows, sort and merge identical rows.
// Shared by the sparse (rpvg_build_cluster_probs) and dense
// (rpvg_build_cluster_matrices) entry points.
std::vector<RppRow> build_cluster_rows(
    const Index& idx, const uint8_t* entries, int64_t entries_len,
    int64_t n_entries, const int64_t* cluster_path_ids, int64_t n_paths,
    const double* eff_lengths, const int32_t* group_of, int64_t n_groups,
    const double* log_source_counts, const double* frag_log_probs,
    int64_t frag_table_size, int32_t is_single_end, double min_noise_prob,
    double prob_precision) {
  constexpr double NEG_MAX = -std::numeric_limits<double>::max();

  bool collapse = n_groups > 0;
  int64_t n_cols = collapse ? n_groups : n_paths;

  std::vector<RppRow> rows;
  rows.reserve(n_entries);

  Reader reader{entries, entries + entries_len};
  std::vector<int64_t> located;
  std::vector<double> read_path_log_probs(n_cols);
  std::vector<double> path_log_probs(n_paths);
  std::vector<double> max_align_lengths(n_paths);

  for (int64_t e = 0; e < n_entries; ++e) {
    uint64_t count = reader.get<uint64_t>();
    int32_t n_align_paths = reader.get<int32_t>();

    RppRow row;
    row.read_count = count;
    row.noise_prob = 1.0;

    // Parse the alignment paths (last one is the noise record).
    struct APView {
      const int64_t* positions;
      int32_t n_pos;
      int32_t mapq, score_sum, align_length, frag_length;
    };
    std::vector<APView> aps(n_align_paths);
    for (int32_t i = 0; i < n_align_paths; ++i) {
      reader.get<int64_t>();  // node
      int32_t n_pos = reader.get<int32_t>();
      aps[i].positions = reinterpret_cast<const int64_t*>(reader.ptr);
      reader.ptr += 8 * n_pos;
      aps[i].n_pos = n_pos;
      reader.get<uint8_t>();  // is_simple
      aps[i].mapq = reader.get<int32_t>();
      aps[i].score_sum = reader.get<int32_t>();
      aps[i].align_length = reader.get<int32_t>();
      aps[i].frag_length = reader.get<int32_t>();
    }

    if (aps[0].mapq > 0) {
      double noise = std::max(
          prob_precision,
          std::max(min_noise_prob, std::pow(10.0, -aps[0].mapq / 10.0)));
      double noise_log = aps[n_align_paths - 1].score_sum * NOISE_SCORE_LOG_BASE;
      noise += (1.0 - noise) * std::exp(noise_log);
      row.noise_prob = noise;

      if (aps[n_align_paths - 1].score_sum != 0) {
        std::fill(path_log_probs.begin(), path_log_probs.end(), NEG_MAX);
        std::fill(max_align_lengths.begin(), max_align_lengths.end(), 0.0);

        for (int32_t i = 0; i < n_align_paths - 1; ++i) {
          double log_prob = aps[i].score_sum * SCORE_LOG_BASE;
          if (!is_single_end) {
            int32_t fl = aps[i].frag_length;
            log_prob += (fl < frag_table_size) ? frag_log_probs[fl] : NEG_MAX;
          }
          locate_path_ids(idx, aps[i].positions, aps[i].n_pos, &located);
          for (int64_t pid : located) {
            auto it = std::lower_bound(cluster_path_ids,
                                       cluster_path_ids + n_paths, pid);
            int64_t local = it - cluster_path_ids;
            double eff = eff_lengths[local];
            if (eff == 0.0) continue;
            double lp = log_prob - std::log(eff);
            if (aps[i].align_length > max_align_lengths[local]) {
              path_log_probs[local] = lp;
              max_align_lengths[local] = aps[i].align_length;
            } else if (aps[i].align_length == max_align_lengths[local]) {
              path_log_probs[local] = std::max(path_log_probs[local], lp);
            }
          }
        }

        const double* col_log_probs = path_log_probs.data();
        if (collapse) {
          std::fill(read_path_log_probs.begin(), read_path_log_probs.end(), NEG_MAX);
          for (int64_t p = 0; p < n_paths; ++p) {
            int32_t g = group_of[p];
            read_path_log_probs[g] = add_log(
                read_path_log_probs[g], path_log_probs[p] + log_source_counts[p]);
          }
          col_log_probs = read_path_log_probs.data();
        }

        double log_sum = NEG_MAX;
        for (int64_t c = 0; c < n_cols; ++c) log_sum = add_log(log_sum, col_log_probs[c]);

        double low_prob_sum = 0.0;
        for (int64_t c = 0; c < n_cols; ++c) {
          double prob = std::exp(col_log_probs[c] - log_sum);
          if (prob >= prob_precision) {
            bool merged = false;
            for (auto& [entry_prob, entry_ids] : row.path_probs) {
              if (std::abs(entry_prob - prob) < prob_precision) {
                entry_prob = (entry_prob * entry_ids.size() + prob) /
                             (entry_ids.size() + 1);
                entry_ids.push_back(static_cast<int32_t>(c));
                merged = true;
                break;
              }
            }
            if (!merged) {
              row.path_probs.push_back({prob, {static_cast<int32_t>(c)}});
            }
          } else {
            low_prob_sum += prob;
          }
        }
        for (auto& entry : row.path_probs) entry.first *= (1.0 - row.noise_prob);
        row.noise_prob += low_prob_sum * (1.0 - row.noise_prob);
        std::sort(row.path_probs.begin(), row.path_probs.end());
      }
    }
    rows.push_back(std::move(row));
  }

  std::sort(rows.begin(), rows.end(), rpp_row_less);

  std::vector<RppRow> merged;
  merged.reserve(rows.size());
  for (auto& row : rows) {
    if (!merged.empty() && rpp_merge_identical(&merged.back(), row, prob_precision)) {
      continue;
    }
    merged.push_back(std::move(row));
  }
  return merged;
}

}  // namespace

extern "C" {

uint8_t* rpvg_build_cluster_probs(
    void* handle, const uint8_t* entries, int64_t entries_len, int64_t n_entries,
    const int64_t* cluster_path_ids, int64_t n_paths,
    const double* eff_lengths, const int32_t* group_of, int64_t n_groups,
    const double* log_source_counts, const double* frag_log_probs,
    int64_t frag_table_size, int32_t is_single_end, double min_noise_prob,
    double prob_precision, int64_t* out_len) {
  const Index& idx = *static_cast<Index*>(handle);
  std::vector<RppRow> merged = build_cluster_rows(
      idx, entries, entries_len, n_entries, cluster_path_ids, n_paths,
      eff_lengths, group_of, n_groups, log_source_counts, frag_log_probs,
      frag_table_size, is_single_end, min_noise_prob, prob_precision);

  Writer w;
  w.put<uint64_t>(merged.size());
  for (const auto& row : merged) {
    w.put<uint64_t>(row.read_count);
    w.put<double>(row.noise_prob);
    w.put<int32_t>(static_cast<int32_t>(row.path_probs.size()));
    for (const auto& [prob, ids] : row.path_probs) {
      w.put<double>(prob);
      w.put<int32_t>(static_cast<int32_t>(ids.size()));
      for (int32_t id : ids) w.put<int32_t>(id);
    }
  }
  *out_len = static_cast<int64_t>(w.buf.size());
  auto* out = static_cast<uint8_t*>(std::malloc(w.buf.size()));
  std::memcpy(out, w.buf.data(), w.buf.size());
  return out;
}

// Batched dense twin: builds every cluster's probability matrix in one
// call, parallelised over clusters with worker threads.  Per-cluster
// inputs are concatenated with prefix offsets.  Output layout per
// cluster (concatenated in cluster order):
//   u64 R, f64 probs[R * n_cols], f64 noise[R], f64 counts[R]
// where n_cols = n_groups[c] when grouping else n_paths[c].  The dense
// matrix is elementwise identical to assembling
// construct_probability_matrix from the sparse rows.
uint8_t* rpvg_build_cluster_matrices(
    void* handle, const uint8_t* entries_blob, const int64_t* blob_offsets,
    const int64_t* entry_counts, int64_t n_clusters,
    const int64_t* path_ids_concat, const int64_t* path_offsets,
    const double* eff_lengths_concat, const int32_t* group_of_concat,
    const int64_t* n_groups, const double* log_source_counts_concat,
    const double* frag_log_probs, int64_t frag_table_size,
    int32_t is_single_end, double min_noise_prob, double prob_precision,
    int32_t n_threads, int64_t* out_len) {
  const Index& idx = *static_cast<Index*>(handle);

  std::vector<std::vector<uint8_t>> results(n_clusters);
  std::atomic<int64_t> next{0};

  auto worker = [&]() {
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= n_clusters) return;
      int64_t n_paths = path_offsets[c + 1] - path_offsets[c];
      int64_t n_cols = n_groups[c] > 0 ? n_groups[c] : n_paths;

      std::vector<RppRow> merged = build_cluster_rows(
          idx, entries_blob + blob_offsets[c],
          blob_offsets[c + 1] - blob_offsets[c], entry_counts[c],
          path_ids_concat + path_offsets[c], n_paths,
          eff_lengths_concat + path_offsets[c],
          group_of_concat + path_offsets[c], n_groups[c],
          log_source_counts_concat + path_offsets[c], frag_log_probs,
          frag_table_size, is_single_end, min_noise_prob, prob_precision);

      int64_t R = static_cast<int64_t>(merged.size());
      std::vector<uint8_t>& out = results[c];
      out.resize(8 + sizeof(double) * (R * n_cols + 2 * R));
      std::memcpy(out.data(), &R, 8);
      double* probs = reinterpret_cast<double*>(out.data() + 8);
      double* noise = probs + R * n_cols;
      double* counts = noise + R;
      std::fill(probs, probs + R * n_cols, 0.0);
      for (int64_t r = 0; r < R; ++r) {
        const RppRow& row = merged[r];
        for (const auto& [prob, ids] : row.path_probs) {
          for (int32_t id : ids) probs[r * n_cols + id] = prob;
        }
        noise[r] = row.noise_prob;
        counts[r] = static_cast<double>(row.read_count);
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  size_t total = 0;
  for (const auto& r : results) total += r.size();
  auto* out = static_cast<uint8_t*>(std::malloc(total));
  size_t offset = 0;
  for (const auto& r : results) {
    std::memcpy(out + offset, r.data(), r.size());
    offset += r.size();
  }
  *out_len = static_cast<int64_t>(total);
  return out;
}

// '-b' probability-writer rows (reference threaded_output_writer.cpp:
// 40-95): the same per-cluster ReadPathProbs rows the matrix builder
// derives, formatted as text — "count noise prob:ids..." lines — so
// the probability writer runs off the fast columnar path.  Python adds
// the '#' delimiter and the path header line.
uint8_t* rpvg_format_prob_rows_multi(
    void* handle, const uint8_t* entries_blob, const int64_t* blob_offsets,
    const int64_t* entry_counts, int64_t n_clusters,
    const int64_t* path_ids_concat, const int64_t* path_offsets,
    const double* eff_lengths_concat, const int32_t* group_of_concat,
    const int64_t* n_groups, const double* log_source_counts_concat,
    const double* frag_log_probs, int64_t frag_table_size,
    int32_t is_single_end, double min_noise_prob, double prob_precision,
    int32_t digits, int32_t n_threads, int64_t* out_len) {
  const Index& idx = *static_cast<Index*>(handle);

  std::vector<std::string> texts(n_clusters);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    char buf[64];
    for (;;) {
      int64_t c = next.fetch_add(1);
      if (c >= n_clusters) return;
      int64_t n_paths = path_offsets[c + 1] - path_offsets[c];

      std::vector<RppRow> merged = build_cluster_rows(
          idx, entries_blob + blob_offsets[c],
          blob_offsets[c + 1] - blob_offsets[c], entry_counts[c],
          path_ids_concat + path_offsets[c], n_paths,
          eff_lengths_concat + path_offsets[c],
          group_of_concat + path_offsets[c], n_groups[c],
          log_source_counts_concat + path_offsets[c], frag_log_probs,
          frag_table_size, is_single_end, min_noise_prob, prob_precision);

      std::string& out = texts[c];
      for (const RppRow& row : merged) {
        out.append(std::to_string(row.read_count));
        out.push_back(' ');
        int len = std::snprintf(buf, sizeof(buf), "%.*g",
                                static_cast<int>(digits), row.noise_prob);
        out.append(buf, len);
        for (const auto& [prob, ids] : row.path_probs) {
          out.push_back(' ');
          len = std::snprintf(buf, sizeof(buf), "%.*g",
                              static_cast<int>(digits), prob);
          out.append(buf, len);
          out.push_back(':');
          for (size_t i = 0; i < ids.size(); ++i) {
            if (i) out.push_back(',');
            out.append(std::to_string(ids[i]));
          }
        }
        out.push_back('\n');
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  size_t total = 8 + n_clusters * 8;
  for (const auto& t : texts) total += t.size();
  auto* out = static_cast<uint8_t*>(std::malloc(total));
  size_t off = 0;
  std::memcpy(out + off, &n_clusters, 8);
  off += 8;
  for (const auto& t : texts) {
    const int64_t len = static_cast<int64_t>(t.size());
    std::memcpy(out + off, &len, 8);
    off += 8;
  }
  for (const auto& t : texts) {
    std::memcpy(out + off, t.data(), t.size());
    off += t.size();
  }
  *out_len = static_cast<int64_t>(off);
  return out;
}

}  // extern "C"

extern "C" {

// Dump the deduplicated index: [u64 n_entries][per entry: u64 count +
// path-list block][u64 unaligned][i64 histogram...]
uint8_t* rpvg_indexer_dump(void* indexer, int64_t* out_len) {
  auto* fidx = static_cast<NativeFragmentIndex*>(indexer);
  fidx->merge_workers();
  // Canonical order: the stream's first-seen ordinal (thread-count and
  // schedule independent).
  std::vector<const std::pair<const std::string, EntryVal>*> order;
  order.reserve(fidx->entries.size());
  for (const auto& item : fidx->entries) order.push_back(&item);
  std::sort(order.begin(), order.end(),
            [](const auto* a, const auto* b) {
              return a->second.ord < b->second.ord;
            });
  Writer w;
  size_t payload = 0;
  for (const auto& [key, val] : fidx->entries) payload += key.size() + 8;
  w.buf.reserve(payload + 16 + fidx->histogram.size() * 8);
  w.put<uint64_t>(fidx->entries.size());
  for (const auto* item : order) {
    w.put<uint64_t>(item->second.count);
    size_t offset = w.buf.size();
    w.buf.resize(offset + item->first.size());
    std::memcpy(w.buf.data() + offset, item->first.data(), item->first.size());
  }
  w.put<uint64_t>(fidx->unaligned);
  for (int64_t h : fidx->histogram) w.put<int64_t>(h);

  *out_len = static_cast<int64_t>(w.buf.size());
  auto* out = static_cast<uint8_t*>(std::malloc(w.buf.size()));
  std::memcpy(out, w.buf.data(), w.buf.size());
  return out;
}

}  // extern "C"

extern "C" {

// Row collapse for probability matrices (the speed path behind
// rpvg_tpu/infer/matrices.py:read_collapse; reference semantics
// src/path_estimator.cpp:197-259): sort rows lexicographically by
// (values..., count), then merge each row whose every element is within
// `precision` of the last kept row, summing counts.  Kept rows are
// compacted into the front of probs/counts; returns the kept count.
int64_t rpvg_read_collapse(double* probs, double* counts, int64_t R,
                           int64_t C, double precision) {
  if (R == 0) return 0;
  std::vector<int64_t> order(R);
  for (int64_t i = 0; i < R; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    const double* ra = probs + a * C;
    const double* rb = probs + b * C;
    for (int64_t j = 0; j < C; ++j) {
      if (ra[j] < rb[j]) return true;
      if (ra[j] > rb[j]) return false;
    }
    return counts[a] < counts[b];
  });

  std::vector<double> out_probs;
  out_probs.reserve(R * C);
  std::vector<double> out_counts;
  out_counts.reserve(R);
  for (int64_t i : order) {
    const double* row = probs + i * C;
    if (!out_counts.empty()) {
      const double* kept = out_probs.data() + (out_counts.size() - 1) * C;
      bool same = true;
      for (int64_t j = 0; j < C; ++j) {
        if (std::abs(kept[j] - row[j]) >= precision) { same = false; break; }
      }
      if (same) {
        out_counts.back() += counts[i];
        continue;
      }
    }
    out_probs.insert(out_probs.end(), row, row + C);
    out_counts.push_back(counts[i]);
  }

  int64_t kept = static_cast<int64_t>(out_counts.size());
  std::memcpy(probs, out_probs.data(), kept * C * sizeof(double));
  std::memcpy(counts, out_counts.data(), kept * sizeof(double));
  return kept;
}

}  // extern "C"

extern "C" {

// Dump the deduplicated index with pre-located path ids: per entry the
// anchor path id (first located id of the first alignment path) and
// the sorted-unique union of located ids across its alignment paths —
// everything Python-side clustering/partitioning needs — plus the raw
// serialized entry consumed by rpvg_build_cluster_probs.  Columnar
// layout so Python decodes with array slicing:
//   u64 n_entries
//   u64 counts[n], i64 anchors[n], i32 n_ids[n],
//   i64 ids_total, i64 ids[ids_total],
//   i64 raw_lens[n] (each 8 + key size), raw blocks concatenated
//   (u64 count + path-list block per entry),
//   u64 unaligned, i64 histogram...
uint8_t* rpvg_indexer_dump_located(void* indexer, void* index_handle,
                                   int64_t* out_len, int32_t n_threads) {
  auto* fidx = static_cast<NativeFragmentIndex*>(indexer);
  const bool prof = prof_on();
  uint64_t tp0 = prof ? prof_wall() : 0;
  const Index& idx = *static_cast<Index*>(index_handle);

  // Merge the per-worker dedup maps hash-sharded in parallel: shard s
  // owns the keys whose (cheap content-derived) mix lands on s, so the
  // same fragment list always merges in one shard regardless of which
  // workers saw it.  Entry order = ascending first-seen ordinal (the
  // single-threaded stream order), restored by a global sort after the
  // shard merge — canonical across thread counts and the
  // work-stealing schedule.  Keys stay owned by the worker maps (not
  // cleared) so entry pointers remain valid for the locate pass.
  struct MergedEntry {
    const std::string* key;
    uint64_t count;
    uint64_t ord;
  };
  const int32_t merge_shards = std::max(
      1, std::min<int32_t>(n_threads > 0 ? n_threads : 1, 16));
  std::vector<std::vector<MergedEntry>> shard_lists(merge_shards);
  {
    // Worker maps plus any legacy pre-merged content.
    std::vector<const std::unordered_map<std::string, EntryVal>*> sources;
    if (!fidx->entries.empty()) sources.push_back(&fidx->entries);
    for (const auto& local : fidx->worker_entries) sources.push_back(&local);

    auto shard_of = [merge_shards](const std::string& key) -> int32_t {
      // First path's node id (bytes 4..12) carries the entropy; the
      // serialized prefix (path count) does not.
      uint64_t x = static_cast<uint64_t>(key.size());
      if (key.size() >= 12) {
        uint64_t node;
        std::memcpy(&node, key.data() + 4, 8);
        x ^= node;
      }
      x *= 0x9e3779b97f4a7c15ull;
      x ^= x >> 32;
      return static_cast<int32_t>(x % static_cast<uint64_t>(merge_shards));
    };

    size_t total_src = 0;
    for (const auto* src : sources) total_src += src->size();
    auto merge_shard = [&](int32_t s) {
      auto& list = shard_lists[s];
      list.reserve(total_src / merge_shards + 16);
      std::unordered_map<std::string_view, size_t> seen;
      seen.reserve(total_src / merge_shards + 16);
      for (const auto* src : sources) {
        for (const auto& [key, val] : *src) {
          if (shard_of(key) != s) continue;
          auto [it, inserted] =
              seen.emplace(std::string_view(key), list.size());
          if (inserted) {
            list.push_back(MergedEntry{&key, val.count, val.ord});
          } else {
            list[it->second].count += val.count;
            list[it->second].ord = std::min(list[it->second].ord, val.ord);
          }
        }
      }
    };
    if (merge_shards == 1) {
      merge_shard(0);
    } else {
      std::vector<std::thread> pool;
      pool.reserve(merge_shards);
      for (int32_t s = 0; s < merge_shards; ++s)
        pool.emplace_back(merge_shard, s);
      for (auto& th : pool) th.join();
    }
  }

  std::vector<MergedEntry> entry_list;
  {
    size_t total = 0;
    for (const auto& list : shard_lists) total += list.size();
    entry_list.reserve(total);
    for (auto& list : shard_lists) {
      entry_list.insert(entry_list.end(), list.begin(), list.end());
      list.clear();
      list.shrink_to_fit();
    }
  }
  // Canonical entry order: ascending first-seen ordinal.
  std::sort(entry_list.begin(), entry_list.end(),
            [](const MergedEntry& a, const MergedEntry& b) {
              return a.ord < b.ord;
            });
  const int64_t n = static_cast<int64_t>(entry_list.size());
  uint64_t tp1 = prof ? prof_wall() : 0;

  std::vector<uint64_t> counts(n);
  std::vector<int64_t> anchors(n);
  std::vector<int32_t> n_ids(n);
  std::vector<int64_t> raw_lens(n);
  const int32_t threads =
      std::max(1, std::min<int32_t>(n_threads, std::max<int64_t>(1, n)));
  std::vector<std::vector<int64_t>> ids_of_range(threads);
  size_t raw_total = 0;

  auto process_range = [&](int32_t t) {
    const int64_t begin = n * t / threads;
    const int64_t end = n * (t + 1) / threads;
    std::vector<int64_t>& range_ids = ids_of_range[t];
    std::vector<int64_t> located;
    std::vector<int64_t> ids;
    for (int64_t e = begin; e < end; ++e) {
      const std::string& key = *entry_list[e].key;
      const uint8_t* p = reinterpret_cast<const uint8_t*>(key.data());
      int32_t n_paths;
      std::memcpy(&n_paths, p, 4);
      const uint8_t* cur = p + 4;

      int64_t anchor = -1;
      ids.clear();
      for (int32_t i = 0; i < n_paths; ++i) {
        int32_t n_pos;
        std::memcpy(&n_pos, cur + 8, 4);
        const int64_t* positions = reinterpret_cast<const int64_t*>(cur + 12);
        if (n_pos > 0) {
          locate_path_ids(idx, positions, n_pos, &located);
          if (anchor < 0) anchor = located.front();
          ids.insert(ids.end(), located.begin(), located.end());
        }
        cur += 12 + 8 * static_cast<int64_t>(n_pos) + 17;
      }
      std::sort(ids.begin(), ids.end());
      ids.erase(std::unique(ids.begin(), ids.end()), ids.end());

      counts[e] = entry_list[e].count;
      anchors[e] = anchor;
      n_ids[e] = static_cast<int32_t>(ids.size());
      range_ids.insert(range_ids.end(), ids.begin(), ids.end());
      raw_lens[e] = static_cast<int64_t>(8 + key.size());
    }
  };

  uint64_t tp2 = prof ? prof_wall() : 0;
  if (threads == 1) {
    process_range(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(process_range, t);
    for (auto& th : pool) th.join();
  }
  uint64_t tp3 = prof ? prof_wall() : 0;

  std::vector<int64_t> all_ids;
  {
    size_t ids_total = 0;
    for (const auto& range_ids : ids_of_range) ids_total += range_ids.size();
    all_ids.reserve(ids_total);
    for (const auto& range_ids : ids_of_range) {
      all_ids.insert(all_ids.end(), range_ids.begin(), range_ids.end());
    }
  }
  for (int64_t e = 0; e < n; ++e) raw_total += raw_lens[e];

  // Exact-size single allocation, filled in place (the Writer-based
  // assembly copied the ~entry-blob-sized buffer twice: once into the
  // Writer, once into the malloc'd return) with the entry blob — the
  // dominant section — copied on the worker threads.
  const size_t total_bytes = 8 + static_cast<size_t>(n) * 28 + 8 +
                             all_ids.size() * 8 + raw_total + 8 +
                             fidx->histogram.size() * 8;
  auto* out = static_cast<uint8_t*>(std::malloc(total_bytes));
  if (out == nullptr) {
    // Multi-GB dumps can exhaust the host: signal the caller (nullptr +
    // out_len = -1) instead of memcpy'ing into nullptr on the fill
    // threads below.
    *out_len = -1;
    return nullptr;
  }
  uint8_t* cur = out;
  auto put_scalar = [&cur](uint64_t v) {
    std::memcpy(cur, &v, 8);
    cur += 8;
  };
  auto put_block = [&cur](const void* src, size_t bytes) {
    std::memcpy(cur, src, bytes);
    cur += bytes;
  };
  put_scalar(static_cast<uint64_t>(n));
  put_block(counts.data(), n * 8);
  put_block(anchors.data(), n * 8);
  put_block(n_ids.data(), n * 4);
  put_scalar(static_cast<uint64_t>(all_ids.size()));
  put_block(all_ids.data(), all_ids.size() * 8);
  put_block(raw_lens.data(), n * 8);

  // Per-entry output offsets into the blob section = prefix sums of
  // raw_lens; each entry writes its merged count followed by the key.
  std::vector<int64_t> blob_offsets(n + 1);
  blob_offsets[0] = 0;
  for (int64_t e = 0; e < n; ++e) blob_offsets[e + 1] = blob_offsets[e] + raw_lens[e];
  uint8_t* blob_base = cur;
  auto fill_blob = [&](int32_t t) {
    const int64_t begin = n * t / threads;
    const int64_t end = n * (t + 1) / threads;
    for (int64_t e = begin; e < end; ++e) {
      uint8_t* dst = blob_base + blob_offsets[e];
      const uint64_t count = counts[e];
      std::memcpy(dst, &count, 8);
      std::memcpy(dst + 8, entry_list[e].key->data(), entry_list[e].key->size());
    }
  };
  if (threads == 1 || n == 0) {
    fill_blob(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(fill_blob, t);
    for (auto& th : pool) th.join();
  }
  cur = blob_base + raw_total;
  put_scalar(fidx->unaligned);
  for (int64_t h : fidx->histogram) put_scalar(static_cast<uint64_t>(h));
  assert(static_cast<size_t>(cur - out) == total_bytes);

  *out_len = static_cast<int64_t>(total_bytes);
  if (prof) {
    std::fprintf(stderr,
                 "  [native-prof] dump wall: merge %.3fs locate %.3fs "
                 "serialize %.3fs (%lld entries, %zu bytes)\n",
                 (tp1 - tp0) * 1e-9, (tp3 - tp2) * 1e-9,
                 (prof_wall() - tp3) * 1e-9,
                 static_cast<long long>(n), total_bytes);
  }
  return out;
}


// Locate-throughput microbenchmark entry (r-index divergence evidence,
// reference src/paths_index.cpp:100-143: the reference routes locate
// through the FastLocate r-index when a .ri is supplied; this build's
// functional replacement is the CSR occurrence index + binary search
// below, same code path as production locate_path_ids).  Runs
// locate_path_ids over n_states CSR-packed position lists and returns
// the total located ids; wall time is measured by the caller.
int64_t rpvg_locate_bench(void* index_handle, const int64_t* positions,
                          const int64_t* bounds, int64_t n_states,
                          int32_t repeats) {
  const Index& idx = *static_cast<Index*>(index_handle);
  std::vector<int64_t> located;
  int64_t total = 0;
  for (int32_t r = 0; r < repeats; ++r) {
    for (int64_t s = 0; s < n_states; ++s) {
      locate_path_ids(idx, positions + bounds[s],
                      static_cast<int32_t>(bounds[s + 1] - bounds[s]), &located);
      total += static_cast<int64_t>(located.size());
    }
  }
  return total;
}

}  // extern "C"


// Shared single instantiations of the EM fixed point and the diploid
// score/select loop: the standalone ragged kernels AND the fused
// nested kernel call these same compiled bodies (noinline), so their
// results are bitwise identical regardless of caller-specific codegen
// (FP contraction may otherwise differ between inlined copies).
// Returns the consecutive-converged-iteration counter at exit
// (>= MIN_CONV_ITS means the convergence contract was met within
// max_its) — callers running with a bounded iteration budget use this
// to escalate slow-converging tasks (the EM time distribution is
// heavy-tailed: a handful of tasks run thousands of iterations and
// dominate the host inference phase), and a resumed run continuing
// from (abund, counter) is bitwise identical to an uninterrupted one
// (the fixed-point iteration is memoryless given its state).
// init_conv_its < 0 starts fresh (uniform abundances); >= 0 resumes
// from the caller-provided abund.
__attribute__((noinline)) static int32_t em_fixed_point_one(
    const double* P, const double* counts, int64_t R, int64_t C,
    int64_t max_its, double conv, std::vector<double>& abund,
    std::vector<double>& fresh, int32_t init_conv_its = -1) {
  constexpr double MIN_ABUNDANCE = 1e-8;
  constexpr int32_t MIN_CONV_ITS = 10;
  double total = 0.0;
  for (int64_t r = 0; r < R; ++r) total += counts[r];
  const double denom = std::max(total, 1.0);
  int32_t conv_its = 0;
  if (init_conv_its >= 0) {
    conv_its = init_conv_its;
  } else {
    abund.assign(C, 1.0 / static_cast<double>(C));
  }
  fresh.assign(C, 0.0);
  for (int64_t it = 0; it < max_its && conv_its < MIN_CONV_ITS; ++it) {
    std::fill(fresh.begin(), fresh.end(), 0.0);
    // Row dots are independent serial chains; interleaving four rows
    // gives 4x ILP on the add-latency-bound reductions while keeping
    // every row's c-ascending summation order (and the per-row E-step
    // scatters in row order), so results stay bitwise identical to the
    // one-row-at-a-time loop.
    int64_t r = 0;
    for (; r + 4 <= R; r += 4) {
      const double* r0 = P + r * C;
      const double* r1 = r0 + C;
      const double* r2 = r1 + C;
      const double* r3 = r2 + C;
      double s0 = 0.0, s1 = 0.0, s2 = 0.0, s3 = 0.0;
      for (int64_t c = 0; c < C; ++c) {
        const double a = abund[c];
        s0 += r0[c] * a;
        s1 += r1[c] * a;
        s2 += r2[c] * a;
        s3 += r3[c] * a;
      }
      if (s0 > 0.0 && s1 > 0.0 && s2 > 0.0 && s3 > 0.0) {
        // Common case: fused scatter with one fresh[c] load/store per
        // four rows; the adds stay in row order per element.
        const double w0 = counts[r] / s0;
        const double w1 = counts[r + 1] / s1;
        const double w2 = counts[r + 2] / s2;
        const double w3 = counts[r + 3] / s3;
        for (int64_t c = 0; c < C; ++c) {
          const double a = abund[c];
          double f = fresh[c];
          f += r0[c] * a * w0;
          f += r1[c] * a * w1;
          f += r2[c] * a * w2;
          f += r3[c] * a * w3;
          fresh[c] = f;
        }
      } else {
        const double sums[4] = {s0, s1, s2, s3};
        const double* rows[4] = {r0, r1, r2, r3};
        for (int64_t i = 0; i < 4; ++i) {
          if (sums[i] > 0.0) {
            const double w = counts[r + i] / sums[i];
            const double* row = rows[i];
            for (int64_t c = 0; c < C; ++c) fresh[c] += row[c] * abund[c] * w;
          }
        }
      }
    }
    for (; r < R; ++r) {
      const double* row = P + r * C;
      double row_sum = 0.0;
      for (int64_t c = 0; c < C; ++c) row_sum += row[c] * abund[c];
      if (row_sum > 0.0) {
        const double w = counts[r] / row_sum;
        for (int64_t c = 0; c < C; ++c) fresh[c] += row[c] * abund[c] * w;
      }
    }
    bool has_conv = true;
    for (int64_t c = 0; c < C; ++c) {
      fresh[c] /= denom;
      if (fresh[c] >= MIN_ABUNDANCE &&
          std::abs(fresh[c] - abund[c]) / fresh[c] > conv) {
        has_conv = false;
      }
    }
    conv_its = has_conv ? conv_its + 1 : 0;
    std::swap(abund, fresh);
  }
  return conv_its;
}


// Shared combine-tail accumulation (reference inferPathSubsetAbundance
// :608-750): one task's posterior-weighted per-transcript-group
// contributions fold into the ge_* accumulator with a first-seen group
// split.  ONE definition shared by the fused kernel and
// rpvg_nested_combine so device-deferred slots can never drift from the
// natively-combined ones.
struct CombineScratch {
  std::vector<int64_t> bg_groups;
  std::vector<std::vector<int64_t>> bg_paths;
  std::vector<std::vector<double>> bg_vals;
};

__attribute__((noinline)) static void combine_task_into(
    const int64_t* collapsed, const int64_t* mult, int64_t n_col,
    const double* pc, double subset_prob, const int64_t* gid,
    CombineScratch& scratch, std::vector<std::vector<int64_t>>& ge_keys,
    std::vector<double>& ge_post, std::vector<std::vector<double>>& ge_abund,
    std::map<std::vector<int64_t>, size_t>& ge_index) {
  auto& bg_groups = scratch.bg_groups;
  auto& bg_paths = scratch.bg_paths;
  auto& bg_vals = scratch.bg_vals;
  bg_groups.clear();
  bg_paths.clear();
  bg_vals.clear();
  for (int64_t j = 0; j < n_col; ++j) {
    const int64_t pid = collapsed[j];
    const int64_t m = mult[j];
    const int64_t g = gid[pid];
    const double contrib = pc[j] * subset_prob / m;
    size_t gi = 0;
    for (; gi < bg_groups.size(); ++gi) {
      if (bg_groups[gi] == g) break;
    }
    if (gi == bg_groups.size()) {
      bg_groups.push_back(g);
      bg_paths.emplace_back();
      bg_vals.emplace_back();
    }
    for (int64_t rep = 0; rep < m; ++rep) {
      bg_paths[gi].push_back(pid);
      bg_vals[gi].push_back(contrib);
    }
  }
  for (size_t gi = 0; gi < bg_groups.size(); ++gi) {
    auto it = ge_index.find(bg_paths[gi]);
    size_t idx;
    if (it == ge_index.end()) {
      idx = ge_keys.size();
      ge_index.emplace(bg_paths[gi], idx);
      ge_keys.push_back(bg_paths[gi]);
      ge_post.push_back(0.0);
      ge_abund.emplace_back(bg_paths[gi].size(), 0.0);
    } else {
      idx = it->second;
    }
    ge_post[idx] += subset_prob;
    auto& acc = ge_abund[idx];
    const auto& vals = bg_vals[gi];
    for (size_t i = 0; i < acc.size(); ++i) acc[i] += vals[i];
  }
}

// The reference's sub-threshold folding (src/path_abundance_estimator.
// cpp:100-113): abundances below 1e-8 zero out, their mass (and the
// noise column) accumulates into the noise count sequentially.
__attribute__((noinline)) static void em_postprocess_one(
    const double* fracs, int64_t width, double total, double* out_counts,
    double* out_noise) {
  constexpr double MIN_ABUNDANCE = 1e-8;
  double noise_acc = 0.0;
  for (int64_t c = 0; c < width - 1; ++c) {
    const double pc = fracs[c] * total;
    if (fracs[c] < MIN_ABUNDANCE) {
      noise_acc += pc;
      out_counts[c] = 0.0;
    } else {
      out_counts[c] = pc;
    }
  }
  *out_noise = noise_acc + fracs[width - 1] * total;
}

__attribute__((noinline)) static int64_t diploid_score_select_one(
    const double* probs, int64_t prob_stride, const double* noise,
    int64_t noise_stride, const double* counts, const double* lf, int64_t R,
    int64_t P, double log_cutoff, std::vector<double>& scores,
    int32_t* pairs, double* post) {
  const double log2v = std::log(2.0);
  const int64_t tri = P * (P + 1) / 2;
  scores.assign(tri, 0.0);
  double max_ll = -std::numeric_limits<double>::infinity();
  int64_t t = 0;
  for (int64_t i = 0; i < P; ++i) {
    for (int64_t j = i; j < P; ++j, ++t) {
      double s = 0.0;
      for (int64_t r = 0; r < R; ++r) {
        const double g = noise[r * noise_stride] +
                         0.5 * probs[r * prob_stride + i] +
                         0.5 * probs[r * prob_stride + j];
        s += counts[r] * (g > 0.0 ? std::log(g)
                                  : -std::numeric_limits<double>::infinity());
      }
      s += lf[i] + lf[j];
      if (i != j) s += log2v;
      scores[t] = s;
      if (s > max_ll) max_ll = s;
    }
  }

  int64_t kept = 0;
  double total = 0.0;
  const bool finite_max = std::isfinite(max_ll);
  t = 0;
  for (int64_t i = 0; i < P; ++i) {
    for (int64_t j = i; j < P; ++j, ++t) {
      if (scores[t] - max_ll >= log_cutoff) {
        pairs[2 * kept] = static_cast<int32_t>(i);
        pairs[2 * kept + 1] = static_cast<int32_t>(j);
        const double e = finite_max
                             ? std::exp(scores[t] - max_ll)
                             : std::numeric_limits<double>::quiet_NaN();
        post[kept] = e;
        total += e;
        ++kept;
      }
    }
  }
  for (int64_t k = 0; k < kept; ++k) post[k] /= total;
  return kept;
}

extern "C" {

// Ragged batched EM (CPU speed path behind rpvg_tpu/infer/batching.py;
// reference convergence contract src/path_abundance_estimator.cpp:47-114):
// per cluster, iterate responsibilities/abundance updates until every
// abundance >= 1e-8 changes by < `conv` relative for 10 consecutive
// iterations (or max_its).  Clusters run independently on worker
// threads, so a batch is bitwise identical to per-cluster calls.
//
// probs_concat: per cluster a row-major (R_b, C_b) block (noise column
// last); out_concat: per cluster C_b abundance fractions.
// Descending-area schedule for the ragged EM batches: workers steal
// from an atomic cursor, so the only imbalance left is a heavy cluster
// picked LAST running alone after the queue drains — starting the
// biggest matrices first bounds that tail by the smallest work items
// (the reference size-sorts its cluster parallel-for the same way,
// src/main.cpp:916-925).  Output slots are fixed by cluster id, so the
// schedule order cannot change results.
static std::vector<int64_t> em_sorted_schedule(const int64_t* n_rows,
                                               const int64_t* n_cols,
                                               int64_t n_clusters) {
  std::vector<int64_t> sched(static_cast<size_t>(n_clusters));
  for (int64_t i = 0; i < n_clusters; ++i) sched[static_cast<size_t>(i)] = i;
  std::stable_sort(sched.begin(), sched.end(), [&](int64_t a, int64_t b) {
    return n_rows[a] * n_cols[a] > n_rows[b] * n_cols[b];
  });
  return sched;
}

void rpvg_em_ragged(const double* probs_concat, const double* counts_concat,
                    const int64_t* mat_offsets, const int64_t* row_offsets,
                    const int64_t* col_offsets, const int64_t* n_rows,
                    const int64_t* n_cols, int64_t n_clusters,
                    int64_t max_its, double conv, int32_t n_threads,
                    double* out_concat) {
  const std::vector<int64_t> sched =
      em_sorted_schedule(n_rows, n_cols, n_clusters);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> abund, fresh;
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_clusters) return;
      const int64_t b = sched[static_cast<size_t>(s)];
      const int64_t R = n_rows[b];
      const int64_t C = n_cols[b];
      const double* P = probs_concat + mat_offsets[b];
      const double* counts = counts_concat + row_offsets[b];
      double* out = out_concat + col_offsets[b];

      em_fixed_point_one(P, counts, R, C, max_its, conv, abund, fresh);
      std::copy(abund.begin(), abund.end(), out);
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// rpvg_em_ragged plus the sub-threshold postprocess fused in: per
// cluster C_b-1 path read counts (floored mass folded to noise) and a
// noise count.  out_counts_concat is laid out at col_offsets[b] - b
// (each cluster is one narrower than its fraction vector).
void rpvg_em_ragged_counts_resume(
    const double* probs_concat, const double* counts_concat,
    const int64_t* mat_offsets, const int64_t* row_offsets,
    const int64_t* col_offsets, const int64_t* n_rows,
    const int64_t* n_cols, int64_t n_clusters, int64_t max_its, double conv,
    int32_t n_threads, const double* init_fracs_concat,
    const int64_t* init_conv_its, double* out_counts_concat,
    double* out_noise) {
  // Warm-start variant: init_fracs_concat (CSR by col_offsets) + the
  // per-cluster convergence counters resume a bounded run
  // bitwise-identically (null inits = fresh uniform start).
  const std::vector<int64_t> sched =
      em_sorted_schedule(n_rows, n_cols, n_clusters);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> abund, fresh;
    for (;;) {
      int64_t s = next.fetch_add(1);
      if (s >= n_clusters) return;
      const int64_t b = sched[static_cast<size_t>(s)];
      const int64_t R = n_rows[b];
      const int64_t C = n_cols[b];
      const double* P = probs_concat + mat_offsets[b];
      const double* counts = counts_concat + row_offsets[b];
      int32_t init_conv = -1;
      if (init_fracs_concat != nullptr) {
        abund.assign(init_fracs_concat + col_offsets[b],
                     init_fracs_concat + col_offsets[b + 1]);
        init_conv = static_cast<int32_t>(init_conv_its[b]);
      }
      em_fixed_point_one(P, counts, R, C, max_its, conv, abund, fresh,
                         init_conv);
      double total = 0.0;
      for (int64_t r = 0; r < R; ++r) total += counts[r];
      em_postprocess_one(abund.data(), C, total,
                         out_counts_concat + col_offsets[b] - b,
                         out_noise + b);
    }
  };
  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

void rpvg_em_ragged_counts(const double* probs_concat,
                           const double* counts_concat,
                           const int64_t* mat_offsets,
                           const int64_t* row_offsets,
                           const int64_t* col_offsets, const int64_t* n_rows,
                           const int64_t* n_cols, int64_t n_clusters,
                           int64_t max_its, double conv, int32_t n_threads,
                           double* out_counts_concat, double* out_noise) {
  rpvg_em_ragged_counts_resume(
      probs_concat, counts_concat, mat_offsets, row_offsets, col_offsets,
      n_rows, n_cols, n_clusters, max_its, conv, n_threads, nullptr, nullptr,
      out_counts_concat, out_noise);
}

}  // extern "C"

extern "C" {

// Ragged batched diplotype pair scoring (CPU speed path behind
// rpvg_tpu/infer/posteriors.py:diploid_posteriors_batched; reference
// branch-and-bound src/path_estimator.cpp:379-473 re-expressed dense):
// per cluster a full symmetric (P, P) matrix of
//   sum_r counts[r] * log(noise[r] + (probs[r,i] + probs[r,j]) / 2)
//   + log_freqs[i] + log_freqs[j]
// Clusters run independently on worker threads.
void rpvg_diploid_scores_ragged(
    const double* probs_concat, const double* noise_concat,
    const double* counts_concat, const double* lf_concat,
    const int64_t* mat_offsets, const int64_t* row_offsets,
    const int64_t* col_offsets, const int64_t* out_offsets,
    const int64_t* n_rows, const int64_t* n_cols, int64_t n_clusters,
    int32_t n_threads, double* out_concat) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_clusters) return;
      const int64_t R = n_rows[b];
      const int64_t P = n_cols[b];
      const double* probs = probs_concat + mat_offsets[b];
      const double* noise = noise_concat + row_offsets[b];
      const double* counts = counts_concat + row_offsets[b];
      const double* lf = lf_concat + col_offsets[b];
      double* out = out_concat + out_offsets[b];

      for (int64_t i = 0; i < P; ++i) {
        for (int64_t j = i; j < P; ++j) {
          double s = 0.0;
          for (int64_t r = 0; r < R; ++r) {
            const double g =
                noise[r] + 0.5 * probs[r * P + i] + 0.5 * probs[r * P + j];
            s += counts[r] * (g > 0.0
                                  ? std::log(g)
                                  : -std::numeric_limits<double>::infinity());
          }
          s += lf[i] + lf[j];
          out[i * P + j] = s;
          out[j * P + i] = s;
        }
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// Fused diplotype scoring + selection (CPU speed path behind
// rpvg_tpu/infer/posteriors.py:_diploid_posteriors_native; reference
// calculatePathGroupPosteriorsBounded src/path_estimator.cpp:379-473
// incl. the final relative-likelihood filter): per cluster, score every
// unordered pair (i <= j) with the multinomial permutation factor
// (log 2 for heterozygous pairs), drop pairs below
// max * min_rel_likelihood, and emit normalised posteriors over the
// kept set — identical to scoring then _diploid_select in Python.
//
// Outputs are written at per-cluster triangle offsets tri_offsets
// (tri = P*(P+1)/2 entries worst case): out_pairs holds (i, j) per kept
// entry at [2*(tri_offsets[b]+k)], out_post the posterior, out_nkeep
// the kept count.  Pairs iterate in row-major upper-triangle order,
// matching np.triu_indices.
void rpvg_diploid_posteriors_ragged(
    const double* probs_concat, const double* noise_concat,
    const double* counts_concat, const double* lf_concat,
    const int64_t* mat_offsets, const int64_t* row_offsets,
    const int64_t* col_offsets, const int64_t* tri_offsets,
    const int64_t* n_rows, const int64_t* n_cols, int64_t n_clusters,
    double min_rel_likelihood, int32_t n_threads, int64_t* out_nkeep,
    int32_t* out_pairs, double* out_post) {
  const double log_cutoff = std::log(min_rel_likelihood);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> scores;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_clusters) return;
      const int64_t R = n_rows[b];
      const int64_t P = n_cols[b];
      const double* probs = probs_concat + mat_offsets[b];
      const double* noise = noise_concat + row_offsets[b];
      const double* counts = counts_concat + row_offsets[b];
      const double* lf = lf_concat + col_offsets[b];

      out_nkeep[b] = diploid_score_select_one(
          probs, P, noise, 1, counts, lf, R, P, log_cutoff, scores,
          out_pairs + 2 * tri_offsets[b], out_post + tri_offsets[b]);
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t2 = 0; t2 < threads; ++t2) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// Selection-only half of rpvg_diploid_posteriors_ragged, for pair
// scores computed elsewhere (the TPU backend computes the (P, P)
// log-likelihood tensors on device and ships them back): apply the
// heterozygous permutation factor, the relative-likelihood cutoff, and
// posterior normalisation over the kept upper-triangle pairs.
// scores_concat: per cluster a row-major (P, P) matrix WITHOUT the
// log 2 heterozygous factor (the raw pair log-likelihood + priors).
void rpvg_diploid_select_ragged(
    const double* scores_concat, const int64_t* score_offsets,
    const int64_t* tri_offsets, const int64_t* n_cols, int64_t n_clusters,
    double min_rel_likelihood, int32_t n_threads, int64_t* out_nkeep,
    int32_t* out_pairs, double* out_post) {
  const double log_cutoff = std::log(min_rel_likelihood);
  const double log2 = std::log(2.0);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> scores;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_clusters) return;
      const int64_t P = n_cols[b];
      const double* in = scores_concat + score_offsets[b];

      scores.assign(P * (P + 1) / 2, 0.0);
      double max_ll = -std::numeric_limits<double>::infinity();
      int64_t t = 0;
      for (int64_t i = 0; i < P; ++i) {
        for (int64_t j = i; j < P; ++j, ++t) {
          double s = in[i * P + j];
          if (i != j) s += log2;
          scores[t] = s;
          if (s > max_ll) max_ll = s;
        }
      }

      int64_t kept = 0;
      int32_t* pairs = out_pairs + 2 * tri_offsets[b];
      double* post = out_post + tri_offsets[b];
      double total = 0.0;
      t = 0;
      for (int64_t i = 0; i < P; ++i) {
        for (int64_t j = i; j < P; ++j, ++t) {
          if (scores[t] - max_ll >= log_cutoff) {
            pairs[2 * kept] = static_cast<int32_t>(i);
            pairs[2 * kept + 1] = static_cast<int32_t>(j);
            const double e = std::exp(scores[t] - max_ll);
            post[kept] = e;
            total += e;
            ++kept;
          }
        }
      }
      for (int64_t k = 0; k < kept; ++k) post[k] /= total;
      out_nkeep[b] = kept;
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_clusters <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t2 = 0; t2 < threads; ++t2) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"

extern "C" {

// Derived-matrix construction for one cluster (CPU speed path behind
// construct_grouped/partial + add_noise_and_normalize + read_collapse,
// rpvg_tpu/infer/matrices.py; reference src/path_estimator.cpp:55-259):
// per job, output columns are sums of source columns of the dense
// matrix (a gather is a singleton sum), the noise column is appended
// with (1 - noise)/rowsum scaling, and rows are collapsed within
// `precision` via the shared sort+merge kernel.
//
// spec_stream per output column: n_src, src ids...; jobs' columns are
// consecutive, delimited by spec_offsets (into spec_stream) and
// job_ncols.  Outputs are written at out_offsets/out_count_offsets
// (sized for R rows); out_rkeep reports the kept row count per job.
static int64_t subset_collapse_job(const double* dense, const double* noise,
                                   const double* counts, int64_t R, int64_t C,
                                   const int64_t* spec, int64_t C_out,
                                   double precision, double* mat, double* cnt) {
  const int64_t width = C_out + 1;
  for (int64_t r = 0; r < R; ++r) {
    const double* row = dense + r * C;
    double* out_row = mat + r * width;
    const int64_t* cur = spec;
    double row_sum = 0.0;
    for (int64_t oc = 0; oc < C_out; ++oc) {
      const int64_t n_src = *cur++;
      double v = 0.0;
      for (int64_t k = 0; k < n_src; ++k) v += row[*cur++];
      out_row[oc] = v;
      row_sum += v;
    }
    const double scale = row_sum > 0.0 ? (1.0 - noise[r]) / row_sum : 0.0;
    for (int64_t oc = 0; oc < C_out; ++oc) out_row[oc] *= scale;
    out_row[C_out] = noise[r];
    cnt[r] = counts[r];
  }
  return rpvg_read_collapse(mat, cnt, R, width, precision);
}

void rpvg_subset_collapse(const double* dense, const double* noise,
                          const double* counts, int64_t R, int64_t C,
                          const int64_t* spec_stream,
                          const int64_t* spec_offsets,
                          const int64_t* job_ncols, int64_t n_jobs,
                          double precision, int64_t* out_rkeep,
                          double* out_mats, const int64_t* out_offsets,
                          double* out_counts,
                          const int64_t* out_count_offsets) {
  for (int64_t j = 0; j < n_jobs; ++j) {
    out_rkeep[j] = subset_collapse_job(
        dense, noise, counts, R, C, spec_stream + spec_offsets[j],
        job_ncols[j], precision, out_mats + out_offsets[j],
        out_counts + out_count_offsets[j]);
  }
}

// Multi-cluster variant: every job names its cluster (job_cluster) and
// all clusters' dense matrices ship concatenated, so the entire
// nested-model preparation (grouped posterior matrices, phase A, and
// per-subset EM matrices, phase C — reference constructGroupedProbabilityMatrix
// src/path_estimator.cpp:115-154 and inferPathSubsetAbundance :608-750)
// runs in ONE native call on worker threads instead of a Python loop of
// per-cluster calls.  Per-job results are bitwise identical to
// rpvg_subset_collapse on the job's cluster.
void rpvg_subset_collapse_multi(
    const double* dense_concat, const double* noise_concat,
    const double* counts_concat, const int64_t* dense_offsets,
    const int64_t* row_offsets, const int64_t* n_rows, const int64_t* n_cols,
    const int64_t* job_cluster, const int64_t* spec_stream,
    const int64_t* spec_offsets, const int64_t* job_ncols, int64_t n_jobs,
    double precision, int32_t n_threads, int64_t* out_rkeep, double* out_mats,
    const int64_t* out_offsets, double* out_counts,
    const int64_t* out_count_offsets) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      int64_t j = next.fetch_add(1);
      if (j >= n_jobs) return;
      const int64_t c = job_cluster[j];
      out_rkeep[j] = subset_collapse_job(
          dense_concat + dense_offsets[c], noise_concat + row_offsets[c],
          counts_concat + row_offsets[c], n_rows[c], n_cols[c],
          spec_stream + spec_offsets[j], job_ncols[j], precision,
          out_mats + out_offsets[j], out_counts + out_count_offsets[j]);
    }
  };
  if (n_threads <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(n_threads);
    for (int32_t t = 0; t < n_threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"

extern "C" {

// Ragged batched read-count Gibbs sampling (CPU speed path behind
// rpvg_tpu/infer/readcount_gibbs.py; reference gibbsReadCountSampler,
// src/path_abundance_estimator.cpp:116-212): binomial-thinning
// multinomial allocation per row + Dirichlet(gamma=1) resampling,
// thinned every `thin_its` iterations.  Each job runs an independent
// mt19937_64 chain seeded from its JAX key, so batching (and sampling
// a longer chain and slicing a prefix) is bitwise stable.
//
// probs_concat: per job row-major (R, C) noise-normalised matrices
// (noise column last); fracs_concat: per job C initial fractions;
// out_concat: per job n_samples[j] * C sampled fractions.
void rpvg_gibbs_ragged(const double* probs_concat, const double* counts_concat,
                       const double* fracs_concat, const uint64_t* seeds,
                       const int64_t* mat_offsets, const int64_t* row_offsets,
                       const int64_t* col_offsets, const int64_t* out_offsets,
                       const int64_t* n_rows, const int64_t* n_cols,
                       const int64_t* n_samples, int64_t n_jobs,
                       int64_t thin_its, double gamma_shape, int32_t n_threads,
                       double* out_concat) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> fracs, post, path_counts;
    for (;;) {
      int64_t j = next.fetch_add(1);
      if (j >= n_jobs) return;
      const int64_t R = n_rows[j];
      const int64_t C = n_cols[j];
      const double* P = probs_concat + mat_offsets[j];
      const double* counts = counts_concat + row_offsets[j];
      double* out = out_concat + out_offsets[j];

      std::mt19937_64 rng(seeds[j]);
      fracs.assign(fracs_concat + col_offsets[j],
                   fracs_concat + col_offsets[j] + C);
      post.resize(C);
      path_counts.resize(C);

      for (int64_t s = 0; s < n_samples[j]; ++s) {
        for (int64_t t = 0; t < thin_its; ++t) {
          std::fill(path_counts.begin(), path_counts.end(), 0.0);
          for (int64_t r = 0; r < R; ++r) {
            const double* row = P + r * C;
            double row_sum = 0.0;
            for (int64_t c = 0; c < C; ++c) {
              post[c] = row[c] * fracs[c];
              row_sum += post[c];
            }
            if (row_sum <= 0.0) continue;
            int64_t remaining = static_cast<int64_t>(counts[r]);
            if (remaining <= 4) {
              // Small counts (the common case: most fragment rows are
              // unique): a multinomial with k trials is k iid
              // categorical draws — one uniform + one CDF walk each,
              // instead of up to C binomial draws.  Identical
              // distribution, different (cheaper) RNG consumption.
              std::uniform_real_distribution<double> unif(0.0, row_sum);
              for (int64_t k = 0; k < remaining; ++k) {
                const double u = unif(rng);
                double acc = 0.0;
                int64_t hit = C - 1;  // fp-rounding fallback: last column
                for (int64_t c = 0; c < C; ++c) {
                  acc += post[c];
                  if (u < acc) { hit = c; break; }
                }
                path_counts[hit] += 1.0;
              }
              continue;
            }
            // Multinomial via sequential binomial splitting.
            double remaining_p = row_sum;
            for (int64_t c = 0; c < C && remaining > 0; ++c) {
              double ratio = remaining_p > 0.0 ? post[c] / remaining_p : 0.0;
              ratio = std::min(1.0, std::max(0.0, ratio));
              int64_t draw;
              if (c == C - 1 || ratio >= 1.0) {
                draw = remaining;
              } else {
                std::binomial_distribution<int64_t> binom(remaining, ratio);
                draw = binom(rng);
              }
              path_counts[c] += static_cast<double>(draw);
              remaining -= draw;
              remaining_p -= post[c];
            }
          }
          double total = 0.0;
          std::uniform_real_distribution<double> unit(0.0, 1.0);
          for (int64_t c = 0; c < C; ++c) {
            // Dirichlet(counts + gamma) resample.  With gamma=1 and
            // integer counts the shape is a small integer for most
            // columns; Gamma(k) is then a sum of k exponentials —
            // exact and several times cheaper than the general
            // Marsaglia-Tsang sampler (this loop dominates the whole
            // Gibbs phase: C draws x thin_its x samples x jobs).
            const double shape = path_counts[c] + gamma_shape;
            double draw;
            if (gamma_shape == 1.0 && path_counts[c] <= 3.0) {
              const int64_t k = static_cast<int64_t>(path_counts[c]) + 1;
              double prod = 1.0;
              for (int64_t i = 0; i < k; ++i) {
                prod *= 1.0 - unit(rng);  // (0,1] -> finite log
              }
              draw = -std::log(prod);  // sum of k exponentials, one log
            } else {
              std::gamma_distribution<double> gamma(shape, 1.0);
              draw = gamma(rng);
            }
            path_counts[c] = draw;
            total += draw;
          }
          for (int64_t c = 0; c < C; ++c) fracs[c] = path_counts[c] / total;
        }
        std::copy(fracs.begin(), fracs.end(), out + s * C);
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_jobs <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"

extern "C" {

// Collapsed diploid posterior Gibbs (CPU speed path behind
// rpvg_tpu/infer/posteriors.py:path_group_posteriors_gibbs_batched for
// group_size == 2; reference sampler with cached conditionals,
// src/path_estimator.cpp:475-589): for ploidy 2 the slot conditional
// given the other slot's path o is categorical over row o of the pair
// log-likelihood matrix (the +lf[o] constant cancels), so chains just
// sample cached rows.  scores_concat: per job a (P, P) matrix from
// rpvg_diploid_scores_ragged; out: per job chains*its sampled pairs
// (2 x int32 each, iterations AFTER burn-in).
void rpvg_posterior_gibbs_ragged(
    const double* scores_concat, const int64_t* score_offsets,
    const int64_t* n_cols, const int64_t* n_chains, const int64_t* n_burn,
    const int64_t* n_its, const uint64_t* seeds, const int64_t* out_offsets,
    int64_t n_jobs, int32_t n_threads, int32_t* out_concat) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<std::vector<double>> cdf_cache;
    for (;;) {
      int64_t j = next.fetch_add(1);
      if (j >= n_jobs) return;
      const int64_t P = n_cols[j];
      const double* S = scores_concat + score_offsets[j];
      int32_t* out = out_concat + out_offsets[j];
      std::mt19937_64 rng(seeds[j]);
      // The conditionals are static (the score matrix never changes),
      // so each visited row's normalised CDF is built once and reused —
      // the reference's cached discrete_distributions
      // (src/path_estimator.cpp:527-555).  One uniform + binary search
      // per step instead of a P-exp row pass.  The cache is bounded
      // (~32MB of CDFs per job); rows beyond the cap compute into a
      // scratch buffer instead of growing the cache without limit.
      const int64_t max_cached_rows =
          std::max<int64_t>(1, (32ll << 20) / (8 * std::max<int64_t>(P, 1)));
      int64_t cached_rows = 0;
      cdf_cache.assign(P, {});
      std::vector<double> scratch;

      auto fill_cdf = [&](int64_t other, std::vector<double>& cdf) {
        const double* row = S + other * P;
        double max_ll = row[0];
        for (int64_t p = 1; p < P; ++p) max_ll = std::max(max_ll, row[p]);
        cdf.resize(P);
        double acc = 0.0;
        for (int64_t p = 0; p < P; ++p) {
          acc += std::exp(row[p] - max_ll);
          cdf[p] = acc;
        }
      };

      auto sample_row = [&](int64_t other) -> int64_t {
        std::vector<double>* cdf = &cdf_cache[other];
        if (cdf->empty()) {
          if (cached_rows < max_cached_rows) {
            fill_cdf(other, *cdf);
            ++cached_rows;
          } else {
            fill_cdf(other, scratch);
            cdf = &scratch;
          }
        }
        std::uniform_real_distribution<double> uni(0.0, cdf->back());
        const double u = uni(rng);
        const int64_t p =
            std::lower_bound(cdf->begin(), cdf->end(), u) - cdf->begin();
        return p < P ? p : P - 1;  // fp-rounding fallback
      };

      for (int64_t c = 0; c < n_chains[j]; ++c) {
        std::uniform_int_distribution<int64_t> init(0, P - 1);
        int64_t g0 = init(rng);
        int64_t g1 = init(rng);
        for (int64_t it = 0; it < n_burn[j] + n_its[j]; ++it) {
          g0 = sample_row(g1);
          g1 = sample_row(g0);
          if (it >= n_burn[j]) {
            int64_t rec = c * n_its[j] + (it - n_burn[j]);
            out[rec * 2] = static_cast<int32_t>(g0);
            out[rec * 2 + 1] = static_cast<int32_t>(g1);
          }
        }
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_jobs <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Skew-normal MLE fit (reference fragment_length_dist.cpp:103-278): MOM
// init + alternating golden-section search on alpha and mu with the
// analytic sigma update.  The scalar math mirrors utils.hpp:142-294
// (erf/erfc branch CDF, asymptotic log-CDF tail, precomputed-step
// golden section) — the sequential-summation likelihood matches the
// reference's own scalar loops.

namespace fitmle {

static const double kSqrt12 = 0.70710678118654757;  // sqrt(1/2)
static const double kInvSqrt2Pi = 0.3989422804014327;
static const double kLogSkewConst = -0.2257913526447274;  // log(2/sqrt(2*pi))

static inline double std_normal_cdf(double z) {
  double x = z * kSqrt12;
  double a = std::fabs(x);
  if (a < kSqrt12) return 0.5 + 0.5 * std::erf(x);
  double y = 0.5 * std::erfc(a);
  return x > 0 ? 1.0 - y : y;
}

static inline double log_std_normal_cdf(double z) {
  if (z > 6.0) return -std_normal_cdf(-z);
  if (z > -20.0) return std::log(std_normal_cdf(z));
  double log_lhs = -0.5 * z * z - std::log(-z) - 0.5 * std::log(2.0 * M_PI);
  double rhs = 1.0, last = 0.0, numerator = 1.0, denom_factor = 1.0;
  double denom_cons = 1.0 / (z * z);
  double sign = 1.0;
  int i = 0;
  while (std::fabs(last - rhs) > 2.220446049250313e-16) {
    ++i;
    last = rhs;
    sign = -sign;
    denom_factor *= denom_cons;
    numerator *= 2 * i - 1;
    rhs += sign * numerator * denom_factor;
  }
  return log_lhs + std::log(rhs);
}

struct LogLik {
  const double* lengths;
  const double* counts;
  int64_t n;
  double operator()(double m, double s, double a) const {
    double total = 0.0;
    double log_s = std::log(s);
    for (int64_t i = 0; i < n; ++i) {
      double z = (lengths[i] - m) / s;
      total += counts[i] * (kLogSkewConst + log_std_normal_cdf(a * z) - log_s - 0.5 * z * z);
    }
    return total;
  }
};

template <typename F>
static double golden_section_search(const F& f, double x_min, double x_max, double tolerance) {
  const double inv_phi = (std::sqrt(5.0) - 1.0) / 2.0;
  int steps = static_cast<int>(std::ceil(std::log(tolerance / (x_max - x_min)) / std::log(inv_phi)));
  double x_lo = x_min + inv_phi * inv_phi * (x_max - x_min);
  double x_hi = x_min + inv_phi * (x_max - x_min);
  double f_lo = f(x_lo);
  double f_hi = f(x_hi);
  for (int i = 0; i < steps; ++i) {
    if (f_lo < f_hi) {
      x_min = x_lo;
      x_lo = x_hi;
      x_hi = x_min + inv_phi * (x_max - x_min);
      f_lo = f_hi;
      f_hi = f(x_hi);
    } else {
      x_max = x_hi;
      x_hi = x_lo;
      x_lo = x_min + inv_phi * inv_phi * (x_max - x_min);
      f_hi = f_lo;
      f_lo = f(x_lo);
    }
  }
  return f_lo > f_hi ? (x_min + x_hi) / 2.0 : (x_lo + x_max) / 2.0;
}

template <typename F>
static void expand_bracket(const F& f, double center, double ll, double* out_left, double* out_right) {
  const double factor = 1.3;
  double left = 1.0;
  while (true) {
    double v = f(center - left);
    if (!(v >= ll) || std::isinf(v)) break;
    if (std::isinf(left * factor)) break;
    left *= factor;
  }
  double right = 1.0;
  while (true) {
    double v = f(center + right);
    if (!(v >= ll) || std::isinf(v)) break;
    if (std::isinf(right * factor)) break;
    right *= factor;
  }
  *out_left = left;
  *out_right = right;
}

}  // namespace fitmle

extern "C" {

void rpvg_fit_skew_normal_mle(const double* counts, int64_t size,
                              double* out_mu, double* out_sigma, double* out_alpha) {
  using namespace fitmle;
  double k0 = 0.0, k1 = 0.0, k2 = 0.0, k3 = 0.0;
  for (int64_t i = 0; i < size; ++i) {
    double len = static_cast<double>(i);
    k0 += counts[i];
    k1 += len * counts[i];
    k2 += len * len * counts[i];
    k3 += len * len * len * counts[i];
  }
  double m1 = k1 / k0;
  double m2 = k2 / k0 - m1 * m1;
  double m3 = k3 / k0 - 3.0 * m1 * m2 - m1 * m1 * m1;

  double mean = m1;
  double sd = std::sqrt(m2);
  double skew = m3 / (sd * sd * sd);

  double alpha = 0.0;
  double sigma = 0.0;
  if (skew != 0.0 && k0 > 2.0) {
    double gam = std::pow(std::min(std::fabs(skew), 0.9952717464311565), 2.0 / 3.0);
    double abs_delta = std::sqrt((M_PI / 2.0) * (gam / (gam + std::pow((4.0 - M_PI) / 2.0, 2.0 / 3.0))));
    double abs_alpha = abs_delta / std::sqrt(1.0 - abs_delta * abs_delta);
    alpha = skew < 0.0 ? -abs_alpha : abs_alpha;
  }
  double delta = alpha / std::sqrt(1.0 + alpha * alpha);
  if (sd != 0.0 && k0 > 1.0) {
    sigma = sd / std::sqrt(1.0 - 2.0 * delta * delta / M_PI);
  }
  double mean_offset = sigma * delta * std::sqrt(2.0 / M_PI);
  double mu_est = mean - mean_offset;

  if (std::fabs(alpha) > 1000.0 * sigma) {
    alpha = std::copysign(1000.0 * sigma, alpha);
  }

  std::vector<double> nz_lengths, nz_counts;
  nz_lengths.reserve(size);
  nz_counts.reserve(size);
  for (int64_t i = 0; i < size; ++i) {
    if (counts[i] > 0) {
      nz_lengths.push_back(static_cast<double>(i));
      nz_counts.push_back(counts[i]);
    }
  }
  LogLik loglik{nz_lengths.data(), nz_counts.data(), static_cast<int64_t>(nz_lengths.size())};

  const double tol = 1e-4;
  double prev_mu = mu_est + 2.0 * tol;
  double prev_alpha = alpha + 2.0 * tol;

  int it = 0;
  while (it < 100 && (std::fabs(prev_mu - mu_est) >= tol || std::fabs(prev_alpha - alpha) >= tol)) {
    ++it;
    prev_mu = mu_est;
    prev_alpha = alpha;

    auto f_alpha = [&](double a) { return loglik(mu_est, sigma, a); };
    double left, right;
    expand_bracket(f_alpha, alpha, f_alpha(alpha), &left, &right);
    alpha = golden_section_search(f_alpha, alpha - left, alpha + right, tol / 4.0);

    auto f_mu = [&](double m) { return loglik(m, sigma, alpha); };
    expand_bracket(f_mu, mu_est, f_mu(mu_est), &left, &right);
    mu_est = golden_section_search(f_mu, mu_est - left, mu_est + right, tol / 4.0);

    double acc = 0.0;
    for (int64_t i = 0; i < size; ++i) {
      double d = static_cast<double>(i) - mu_est;
      acc += d * d * counts[i];
    }
    sigma = std::sqrt(acc / k0);
  }

  *out_mu = mu_est;
  *out_sigma = sigma;
  *out_alpha = alpha;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Fused nested-model inference for the collapsed diploid non-Gibbs
// configuration (the reference's NestedPathAbundanceEstimator::
// inferAbundancesCollapsedGroups, src/path_abundance_estimator.cpp:
// 442-546 + inferPathSubsetAbundance :608-750): grouped-matrix
// construction, dense diploid group posteriors, posterior subset
// selection, per-subset matrix collapse and EM all run inside ONE
// threaded native call, eliminating the per-phase Python marshalling
// between the existing kernels.  Each stage reuses the exact arithmetic
// of its standalone kernel (subset_collapse_job, the
// rpvg_diploid_posteriors_ragged scoring/selection loops, the
// rpvg_em_ragged fixed point), so results are bitwise identical to the
// staged path.

namespace nested {

// Per-slot task output, stream-per-field so the Python side parses the
// whole batch with a handful of array views instead of per-task reads.
struct SlotStreams {
  double total_count = 0.0;
  std::vector<double> subset_prob;
  std::vector<int64_t> n_col;
  std::vector<int64_t> kept;
  std::vector<uint8_t> has_fracs;
  std::vector<int64_t> collapsed;
  std::vector<int64_t> mult;
  std::vector<double> fracs;
  std::vector<double> mats;
  std::vector<double> cnts;
  // Bounded-EM escalation state (one entry per has_fracs==0 task when
  // em_bound_its is active): the exit abundances + convergence counter
  // so the rebatched resume continues bitwise-identically.
  std::vector<double> esc_fracs;
  std::vector<int64_t> esc_conv;
  // Combine outputs (valid when `combined`): the finished per-cluster
  // estimate — group sets, posteriors, abundances, noise count.
  uint8_t combined = 0;
  double noise_count = 0.0;
  std::vector<int64_t> set_lens;
  std::vector<int64_t> set_ids;
  std::vector<double> set_posteriors;
  std::vector<double> set_abundances;
};

}  // namespace nested

extern "C" {

// Columnar serialized output (all i64/f64 little-endian, no padding):
//   i64 n_slots, i64 n_tasks_total,
//   f64 total_count[n_slots], i64 n_tasks[n_slots],
//   f64 subset_prob[T], i64 n_col[T], i64 kept[T], u8 has_fracs[T],
//   i64 collapsed_total, i64 collapsed[collapsed_total],
//   i64 mult[collapsed_total],
//   i64 fracs_total, f64 fracs[fracs_total]          (tasks w/ EM run)
//   i64 mat_total,   f64 mats[mat_total],            (device-EM tasks)
//   i64 cnt_total,   f64 cnts[cnt_total]
uint8_t* rpvg_nested_diploid_infer(
    const double* dense_concat, const double* noise_concat,
    const double* counts_concat, const int64_t* dense_offsets,
    const int64_t* row_offsets, const int64_t* n_rows, const int64_t* n_cols,
    int64_t n_slots, const int64_t* group_spec_stream,
    const int64_t* group_spec_offsets, const int64_t* n_groups,
    const double* lf_concat, const int64_t* group_count_offsets,
    const int64_t* gid_concat, const int64_t* gid_offsets,
    double min_rel_likelihood, double min_hap_prob, double precision,
    int64_t max_em_its, double em_conv, int64_t em_area_cutoff,
    int64_t em_bound_its, int32_t emit_matrices, int32_t n_threads,
    int64_t* out_len) {
  const double log_cutoff = std::log(min_rel_likelihood);
  // Bounded-EM escalation: with em_bound_its > 0 each task gets that
  // iteration budget; tasks that do not converge inside it defer to the
  // device exactly like the area cutoff (has_fracs=0 + emitted matrix),
  // which re-runs from scratch with identical convergence semantics.
  // Self-measuring hybrid policy: the EM-time heavy tail (the few tasks
  // needing thousands of iterations) is what actually pays for the
  // device link, and it is only identifiable by running.
  const int64_t em_budget =
      (em_bound_its > 0 && em_bound_its < max_em_its) ? em_bound_its
                                                      : max_em_its;

  std::vector<nested::SlotStreams> slots(n_slots);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<double> gmat, gcnt, scores, post;
    std::vector<int32_t> pairs;
    std::vector<int64_t> spec, key;
    std::vector<double> tmat, tcnt, abund, fresh;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_slots) return;
      nested::SlotStreams& out = slots[b];
      const int64_t R = n_rows[b];
      const int64_t C = n_cols[b];
      const int64_t G = n_groups[b];
      const double* dense = dense_concat + dense_offsets[b];
      const double* noise = noise_concat + row_offsets[b];
      const double* counts = counts_concat + row_offsets[b];
      const int64_t* gspec = group_spec_stream + group_spec_offsets[b];
      const double* lf = lf_concat + group_count_offsets[b];
      const int64_t* gid = gid_concat + gid_offsets[b];

      double total_count = 0.0;
      for (int64_t r = 0; r < R; ++r) total_count += counts[r];
      out.total_count = total_count;

      // Phase A: grouped (collapsed) probability matrix, width G+1.
      gmat.assign(R * (G + 1), 0.0);
      gcnt.assign(R, 0.0);
      const int64_t Rg = subset_collapse_job(dense, noise, counts, R, C,
                                             gspec, G, precision,
                                             gmat.data(), gcnt.data());

      // Phase B: diploid pair scoring + relative-likelihood selection —
      // the same compiled body as rpvg_diploid_posteriors_ragged, read
      // with row stride G+1 (noise in the trailing column).
      const int64_t tri = G * (G + 1) / 2;
      pairs.assign(2 * tri, 0);
      post.assign(tri, 0.0);
      const int64_t n_kept = diploid_score_select_one(
          gmat.data(), G + 1, gmat.data() + G, G + 1, gcnt.data(), lf,
          Rg, G, log_cutoff, scores, pairs.data(), post.data());
      pairs.resize(2 * n_kept);
      post.resize(n_kept);

      // Phase C: posterior-weighted subset selection in first-seen
      // order (the Python dict-insertion contract).
      std::vector<std::vector<int64_t>> keys;
      std::vector<double> key_probs;
      std::map<std::vector<int64_t>, size_t> key_index;
      double total_posterior = 0.0;
      for (size_t k = 0; k < post.size(); ++k) {
        const double posterior = post[k];
        if (!(posterior >= min_hap_prob)) continue;
        key.clear();
        for (int side = 0; side < 2; ++side) {
          const int64_t g = pairs[2 * k + side];
          const int64_t* cur = gspec;
          for (int64_t gg = 0; gg < g; ++gg) cur += 1 + *cur;
          const int64_t len = *cur++;
          key.insert(key.end(), cur, cur + len);
        }
        std::sort(key.begin(), key.end());
        auto it = key_index.find(key);
        if (it == key_index.end()) {
          key_index.emplace(key, keys.size());
          keys.push_back(key);
          key_probs.push_back(posterior);
        } else {
          key_probs[it->second] += posterior;
        }
        total_posterior += posterior;
      }

      // Emit tasks: collapse + EM per selected subset, accumulating the
      // posterior-weighted combination (reference
      // inferPathSubsetAbundance :608-750 combine tail) alongside.  A
      // slot finishes combined unless any task's EM was deferred to the
      // device (area cutoff) — then Python combines from the streams.
      std::vector<std::vector<int64_t>> ge_keys;
      std::vector<double> ge_post;
      std::vector<std::vector<double>> ge_abund;
      std::map<std::vector<int64_t>, size_t> ge_index;
      std::vector<double> pc_buf;
      CombineScratch combine_scratch;
      double sum_hap = 0.0;
      double noise_combined = 0.0;
      bool all_em = true;

      for (size_t k = 0; k < keys.size(); ++k) {
        const double subset_prob = key_probs[k] / total_posterior;
        if (subset_prob < min_hap_prob) continue;
        const std::vector<int64_t>& kk = keys[k];
        const size_t col_base = out.collapsed.size();
        for (int64_t pid : kk) {
          if (out.collapsed.size() == col_base || pid != out.collapsed.back()) {
            out.collapsed.push_back(pid);
            out.mult.push_back(1);
          } else {
            ++out.mult.back();
          }
        }
        const int64_t n_col =
            static_cast<int64_t>(out.collapsed.size() - col_base);
        spec.clear();
        for (size_t c = col_base; c < out.collapsed.size(); ++c) {
          spec.push_back(1);
          spec.push_back(out.collapsed[c]);
        }
        const int64_t width = n_col + 1;
        tmat.assign(R * width, 0.0);
        tcnt.assign(R, 0.0);
        const int64_t kept = subset_collapse_job(dense, noise, counts, R, C,
                                                 spec.data(), n_col, precision,
                                                 tmat.data(), tcnt.data());
        out.subset_prob.push_back(subset_prob);
        out.n_col.push_back(n_col);
        out.kept.push_back(kept);
        bool run_em =
            em_area_cutoff <= 0 || kept * width < em_area_cutoff;
        bool escalated = false;
        if (run_em) {
          const int32_t conv_its = em_fixed_point_one(
              tmat.data(), tcnt.data(), kept, width, em_budget, em_conv,
              abund, fresh);
          if (conv_its < 10 && em_budget < max_em_its) {
            run_em = false;
            escalated = true;
            // Emit the bounded EM's exit state so the rebatched resume
            // continues bitwise-identically instead of re-running the
            // budget from scratch.
            out.esc_fracs.insert(out.esc_fracs.end(), abund.begin(),
                                 abund.begin() + width);
            out.esc_conv.push_back(conv_its);
          }
        }
        (void)escalated;
        out.has_fracs.push_back(run_em ? 1 : 0);
        if (run_em) {
          out.fracs.insert(out.fracs.end(), abund.begin(), abund.begin() + width);

          if (all_em) {
            pc_buf.assign(n_col, 0.0);
            double tnoise = 0.0;
            em_postprocess_one(abund.data(), width, total_count,
                               pc_buf.data(), &tnoise);
            sum_hap += subset_prob;
            noise_combined += tnoise * subset_prob;
            combine_task_into(out.collapsed.data() + col_base,
                              out.mult.data() + col_base, n_col,
                              pc_buf.data(), subset_prob, gid, combine_scratch,
                              ge_keys, ge_post, ge_abund, ge_index);
          }
        } else {
          all_em = false;
        }
        // Gibbs configurations need every task's collapsed matrix for
        // the read-count sampler (emit_matrices); device-EM handoffs
        // (!run_em) always do.
        if (!run_em || emit_matrices) {
          out.mats.insert(out.mats.end(), tmat.begin(),
                          tmat.begin() + kept * width);
          out.cnts.insert(out.cnts.end(), tcnt.begin(), tcnt.begin() + kept);
        }
      }

      if (all_em) {
        noise_combined += (1.0 - sum_hap) * total_count;
        out.combined = 1;
        out.noise_count = noise_combined;
        for (size_t s = 0; s < ge_keys.size(); ++s) {
          out.set_lens.push_back(static_cast<int64_t>(ge_keys[s].size()));
          out.set_ids.insert(out.set_ids.end(), ge_keys[s].begin(),
                             ge_keys[s].end());
          out.set_posteriors.push_back(ge_post[s]);
          out.set_abundances.insert(out.set_abundances.end(),
                                    ge_abund[s].begin(), ge_abund[s].end());
        }
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_slots <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t2 = 0; t2 < threads; ++t2) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  // Assemble the global streams.
  int64_t n_tasks_total = 0, collapsed_total = 0, fracs_total = 0;
  int64_t mat_total = 0, cnt_total = 0;
  int64_t sets_total = 0, set_ids_total = 0;
  int64_t esc_fracs_total = 0, esc_conv_total = 0;
  for (const auto& s : slots) {
    n_tasks_total += static_cast<int64_t>(s.subset_prob.size());
    collapsed_total += static_cast<int64_t>(s.collapsed.size());
    fracs_total += static_cast<int64_t>(s.fracs.size());
    mat_total += static_cast<int64_t>(s.mats.size());
    cnt_total += static_cast<int64_t>(s.cnts.size());
    sets_total += static_cast<int64_t>(s.set_lens.size());
    set_ids_total += static_cast<int64_t>(s.set_ids.size());
    esc_fracs_total += static_cast<int64_t>(s.esc_fracs.size());
    esc_conv_total += static_cast<int64_t>(s.esc_conv.size());
  }
  const size_t total_bytes =
      16 + n_slots * 16 + n_tasks_total * 25 + 8 + collapsed_total * 16 +
      8 + fracs_total * 8 + 16 + mat_total * 8 + cnt_total * 8 +
      n_slots * 17 + 16 + sets_total * 16 + set_ids_total * 16 +
      16 + esc_fracs_total * 8 + esc_conv_total * 8;
  auto* buf = static_cast<uint8_t*>(std::malloc(total_bytes));
  size_t off = 0;
  auto put_i64 = [&](int64_t v) {
    std::memcpy(buf + off, &v, 8);
    off += 8;
  };
  put_i64(n_slots);
  put_i64(n_tasks_total);
  for (const auto& s : slots) { std::memcpy(buf + off, &s.total_count, 8); off += 8; }
  for (const auto& s : slots) put_i64(static_cast<int64_t>(s.subset_prob.size()));
  auto put_stream = [&](auto getter, size_t elem) {
    for (const auto& s : slots) {
      const auto& v = getter(s);
      std::memcpy(buf + off, v.data(), v.size() * elem);
      off += v.size() * elem;
    }
  };
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.subset_prob; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.n_col; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.kept; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<uint8_t>& { return s.has_fracs; }, 1);
  put_i64(collapsed_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.collapsed; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.mult; }, 8);
  put_i64(fracs_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.fracs; }, 8);
  put_i64(mat_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.mats; }, 8);
  put_i64(cnt_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.cnts; }, 8);
  // Combine streams.
  for (const auto& s : slots) { buf[off] = s.combined; off += 1; }
  for (const auto& s : slots) { std::memcpy(buf + off, &s.noise_count, 8); off += 8; }
  for (const auto& s : slots) put_i64(static_cast<int64_t>(s.set_lens.size()));
  put_i64(sets_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.set_lens; }, 8);
  put_i64(set_ids_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.set_ids; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.set_posteriors; }, 8);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.set_abundances; }, 8);
  // Bounded-EM escalation state (appended last; width-per-task implied
  // by the deferred tasks' n_col+1 in stream order).
  put_i64(esc_fracs_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<double>& { return s.esc_fracs; }, 8);
  put_i64(esc_conv_total);
  put_stream([](const nested::SlotStreams& s) -> const std::vector<int64_t>& { return s.esc_conv; }, 8);
  *out_len = static_cast<int64_t>(off);
  return buf;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Output row formatting (reference threaded_output_writer.cpp:6 —
// ostream precision 8, which prints like printf %.8g): assemble
// '<prefix>\t<num>\t<num>...\n' rows from a prefix byte blob and
// numeric columns in one call, so the Python writers do no per-value
// formatting.

extern "C" {

uint8_t* rpvg_format_rows(const uint8_t* prefix_blob,
                          const int64_t* prefix_offsets, int64_t n_rows,
                          const double* cols_concat, int64_t n_cols,
                          int32_t digits, int64_t* out_len) {
  std::string out;
  out.reserve(static_cast<size_t>(n_rows) * (32 + 16 * n_cols));
  char buf[64];
  for (int64_t r = 0; r < n_rows; ++r) {
    out.append(reinterpret_cast<const char*>(prefix_blob) + prefix_offsets[r],
               prefix_offsets[r + 1] - prefix_offsets[r]);
    for (int64_t c = 0; c < n_cols; ++c) {
      out.push_back('\t');
      const double v = cols_concat[c * n_rows + r];
      if (v != v) {
        out.append("nan", 3);  // glibc prints signed "-nan"; numpy/fmt don't
        continue;
      }
      const int len = std::snprintf(buf, sizeof(buf), "%.*g",
                                    static_cast<int>(digits), v);
      out.append(buf, len);
    }
    out.push_back('\n');
  }
  auto* res = static_cast<uint8_t*>(std::malloc(out.size()));
  std::memcpy(res, out.data(), out.size());
  *out_len = static_cast<int64_t>(out.size());
  return res;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Fused `strains` inference (reference MinimumPathAbundanceEstimator,
// src/path_abundance_estimator.cpp:217-340): per cluster, the greedy
// weighted minimum path cover, the cover sub-matrix collapse and EM run
// in one threaded native call.  Cover weights use log-probability sums
// accumulated in the same row order as the Python spec; the greedy
// argmax replicates its strict first-max semantics (IEEE inf/nan
// division behaviour included).

extern "C" {

// Columnar output:
//   i64 n_slots, i64 cover_total,
//   i64 n_cover[n_slots], f64 total[n_slots], f64 noise[n_slots],
//   i64 kept[n_slots],
//   i64 cover_ids[cover_total], f64 path_counts[cover_total],
//   i64 mat_total, f64 mats[mat_total], i64 cnt_total, f64 cnts[cnt_total]
uint8_t* rpvg_strains_infer(
    const double* dense_concat, const double* noise_concat,
    const double* counts_concat, const int64_t* dense_offsets,
    const int64_t* row_offsets, const int64_t* n_rows, const int64_t* n_cols,
    int64_t n_slots, double precision, int64_t max_em_its, double em_conv,
    int32_t emit_matrices, int32_t n_threads, int64_t* out_len) {
  const double eps100 = std::numeric_limits<double>::epsilon() * 100;

  struct SlotOut {
    int64_t n_cover = 0;
    double total = 0.0;
    double noise_count = 0.0;
    int64_t kept = 0;
    std::vector<int64_t> cover;
    std::vector<double> path_counts;
    std::vector<double> mat;
    std::vector<double> cnt;
  };
  std::vector<SlotOut> slots(n_slots);

  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<uint8_t> cov;
    std::vector<double> w, un, tmat, tcnt, abund, fresh;
    std::vector<int64_t> picked, spec;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_slots) return;
      SlotOut& out = slots[b];
      const int64_t R = n_rows[b];
      const int64_t C = n_cols[b];
      const double* dense = dense_concat + dense_offsets[b];
      const double* noise = noise_concat + row_offsets[b];
      const double* counts = counts_concat + row_offsets[b];

      // Cover matrix, weights (-sum log p * count over covering rows,
      // noise~1 rows excluded) and coverable counts.
      cov.assign(R * C, 0);
      w.assign(C, 0.0);
      un.assign(R, 0.0);
      for (int64_t r = 0; r < R; ++r) {
        double cc = counts[r];
        const double nz = noise[r];
        if (nz == 1.0 || std::abs(nz - 1.0) < std::abs(std::min(nz, 1.0)) * eps100) {
          cc = 0.0;
        }
        un[r] = cc;
        const double* row = dense + r * C;
        for (int64_t c = 0; c < C; ++c) {
          const bool covered = row[c] > 0.0;
          cov[r * C + c] = covered;
          if (cc != 0.0 && covered) w[c] += std::log(row[c]) * cc;
        }
      }
      for (int64_t c = 0; c < C; ++c) w[c] = -w[c];

      // Greedy cover, strict first-max per round (spec mincover.py).
      picked.clear();
      if (C == 1) {
        picked.push_back(0);
      } else {
        for (;;) {
          double un_max = 0.0;
          for (int64_t r = 0; r < R; ++r) un_max = std::max(un_max, un[r]);
          if (!(un_max > 0.0)) break;
          int64_t best = -1;
          double best_score = 0.0;
          for (int64_t c = 0; c < C; ++c) {
            double s = 0.0;
            for (int64_t r = 0; r < R; ++r) {
              if (cov[r * C + c]) s += un[r];
            }
            const double score = s / w[c];
            if (score > best_score) {
              best_score = score;
              best = c;
            }
          }
          if (best < 0) break;  // defensive: uncoverable mass
          picked.push_back(best);
          for (int64_t r = 0; r < R; ++r) {
            if (cov[r * C + best]) un[r] = 0.0;
          }
        }
        std::sort(picked.begin(), picked.end());
      }
      if (picked.empty()) continue;

      // Cover sub-matrix (singleton gather + noise scaling + collapse,
      // the same kernel the nested model uses) then EM + folding.
      const int64_t n_cover = static_cast<int64_t>(picked.size());
      spec.clear();
      for (int64_t pid : picked) {
        spec.push_back(1);
        spec.push_back(pid);
      }
      const int64_t width = n_cover + 1;
      tmat.assign(R * width, 0.0);
      tcnt.assign(R, 0.0);
      const int64_t kept = subset_collapse_job(dense, noise, counts, R, C,
                                               spec.data(), n_cover, precision,
                                               tmat.data(), tcnt.data());
      double total = 0.0;
      for (int64_t r = 0; r < kept; ++r) total += tcnt[r];

      em_fixed_point_one(tmat.data(), tcnt.data(), kept, width, max_em_its,
                         em_conv, abund, fresh);
      out.path_counts.assign(n_cover, 0.0);
      em_postprocess_one(abund.data(), width, total, out.path_counts.data(),
                         &out.noise_count);
      out.n_cover = n_cover;
      out.total = total;
      out.kept = kept;
      out.cover.assign(picked.begin(), picked.end());
      if (emit_matrices) {
        out.mat.assign(tmat.begin(), tmat.begin() + kept * width);
        out.cnt.assign(tcnt.begin(), tcnt.begin() + kept);
      }
    }
  };

  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_slots <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  int64_t cover_total = 0, mat_total = 0, cnt_total = 0;
  for (const auto& s : slots) {
    cover_total += s.n_cover;
    mat_total += static_cast<int64_t>(s.mat.size());
    cnt_total += static_cast<int64_t>(s.cnt.size());
  }
  const size_t total_bytes = 16 + n_slots * 32 + cover_total * 16 + 16 +
                             mat_total * 8 + cnt_total * 8;
  auto* buf = static_cast<uint8_t*>(std::malloc(total_bytes));
  size_t off = 0;
  auto put_i64 = [&](int64_t v) { std::memcpy(buf + off, &v, 8); off += 8; };
  auto put_f64 = [&](double v) { std::memcpy(buf + off, &v, 8); off += 8; };
  put_i64(n_slots);
  put_i64(cover_total);
  for (const auto& s : slots) put_i64(s.n_cover);
  for (const auto& s : slots) put_f64(s.total);
  for (const auto& s : slots) put_f64(s.noise_count);
  for (const auto& s : slots) put_i64(s.kept);
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.cover.data(), s.cover.size() * 8);
    off += s.cover.size() * 8;
  }
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.path_counts.data(), s.path_counts.size() * 8);
    off += s.path_counts.size() * 8;
  }
  put_i64(mat_total);
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.mat.data(), s.mat.size() * 8);
    off += s.mat.size() * 8;
  }
  put_i64(cnt_total);
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.cnt.data(), s.cnt.size() * 8);
    off += s.cnt.size() * 8;
  }
  *out_len = static_cast<int64_t>(off);
  return buf;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Gibbs pair-sample dedup: normalise each sampled diplotype (min,max),
// count occurrences and emit unique pairs in lexicographic order with
// counts — the C++ twin of np.sort(axis=1) + np.unique(axis=0,
// return_counts=True) over the sampler output.

extern "C" {

// Output: i64 n_slots, i64 n_unique[n_slots], i64 uniq_total,
//         i32 pairs[2*uniq_total], i64 counts[uniq_total]
uint8_t* rpvg_pair_dedup_ragged(const int32_t* samples,
                                const int64_t* out_offsets, int64_t n_slots,
                                int32_t n_threads, int64_t* out_len) {
  std::vector<std::vector<int64_t>> keys_of(n_slots);
  std::vector<std::vector<int64_t>> counts_of(n_slots);
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::unordered_map<int64_t, int64_t> m;
    std::vector<int64_t> keys;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_slots) return;
      m.clear();
      const int32_t* p = samples + out_offsets[b];
      const int64_t n_pairs = (out_offsets[b + 1] - out_offsets[b]) / 2;
      for (int64_t s = 0; s < n_pairs; ++s) {
        int64_t a = p[2 * s];
        int64_t c = p[2 * s + 1];
        if (a > c) std::swap(a, c);
        ++m[(a << 32) | c];
      }
      keys.clear();
      keys.reserve(m.size());
      for (const auto& kv : m) keys.push_back(kv.first);
      std::sort(keys.begin(), keys.end());
      keys_of[b] = keys;
      counts_of[b].clear();
      for (int64_t k : keys) counts_of[b].push_back(m[k]);
    }
  };
  int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n_slots <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  int64_t uniq_total = 0;
  for (const auto& k : keys_of) uniq_total += static_cast<int64_t>(k.size());
  const size_t total_bytes = 16 + n_slots * 8 + uniq_total * 16;
  auto* buf = static_cast<uint8_t*>(std::malloc(total_bytes));
  size_t off = 0;
  auto put_i64 = [&](int64_t v) { std::memcpy(buf + off, &v, 8); off += 8; };
  put_i64(n_slots);
  for (const auto& k : keys_of) put_i64(static_cast<int64_t>(k.size()));
  put_i64(uniq_total);
  for (const auto& k : keys_of) {
    for (int64_t key : k) {
      const int32_t pair[2] = {static_cast<int32_t>(key >> 32),
                               static_cast<int32_t>(key & 0xffffffff)};
      std::memcpy(buf + off, pair, 8);
      off += 8;
    }
  }
  for (const auto& c : counts_of) {
    std::memcpy(buf + off, c.data(), c.size() * 8);
    off += c.size() * 8;
  }
  *out_len = static_cast<int64_t>(off);
  return buf;
}

}  // extern "C"

// ---------------------------------------------------------------------
// Columnar composition of the two haplotype-transcripts estimate files
// (HaplotypeAbundanceEstimatesWriter / JointHaplotypeAbundanceEstimates
// Writer, reference threaded_output_writer.cpp:346-432,434-546): the
// fused nested kernel's set streams go straight to row text, bypassing
// the per-cluster Python object walk.  Arithmetic replicates the
// Python writers' numpy expressions op-for-op (sequential adds in slot
// order; tpm = count / eff / total * 1e6) so the composed text is
// byte-identical to the object writers.

namespace compose {

inline void put_g(std::string* out, double v, int digits) {
  char buf[64];
  if (v != v) {
    out->append("nan", 3);  // normalise signed nan like numpy/fmt
    return;
  }
  const int len = std::snprintf(buf, sizeof(buf), "%.*g", digits, v);
  out->append(buf, len);
}

inline void put_i64(std::string* out, int64_t v) {
  char buf[32];
  const int len = std::snprintf(buf, sizeof(buf), "%lld",
                                static_cast<long long>(v));
  out->append(buf, len);
}

inline void put_name(std::string* out, const uint8_t* names_fixed,
                     int64_t width, int64_t row) {
  const uint8_t* base = names_fixed + row * width;
  int64_t len = 0;
  while (len < width && base[len] != 0) ++len;
  out->append(reinterpret_cast<const char*>(base), len);
}

// Run body(c) for c in [0, n) on the worker threads (atomic work
// index; deterministic as long as body(c) touches only slot c's
// outputs).
template <typename Fn>
void parallel_for(int64_t n, int32_t n_threads, const Fn& body) {
  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    for (;;) {
      const int64_t c = next.fetch_add(1);
      if (c >= n) return;
      body(c);
    }
  };
  const int32_t threads = std::max(1, n_threads);
  if (threads == 1 || n <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

// Concatenate chunks into one malloc'd buffer (caller frees via
// rpvg_buffer_free).
inline void concat_chunks(const std::vector<std::string>& chunks,
                          uint8_t** out, int64_t* out_len) {
  size_t total = 0;
  for (const auto& chunk : chunks) total += chunk.size();
  auto* buf = static_cast<uint8_t*>(std::malloc(std::max<size_t>(total, 1)));
  size_t off = 0;
  for (const auto& chunk : chunks) {
    std::memcpy(buf + off, chunk.data(), chunk.size());
    off += chunk.size();
  }
  *out = buf;
  *out_len = static_cast<int64_t>(total);
}

}  // namespace compose

extern "C" {

// Sequential twin of pipeline.compute_tpm_normalizer (reference
// src/main.cpp:1029-1057): total += abundance / eff over every set
// slot in (cluster, set, slot) order, skipping eff <= 0.
double rpvg_tpm_normalizer(const double* effs, const int64_t* n_paths,
                           const int64_t* n_sets, const int64_t* set_lens,
                           const int64_t* set_ids,
                           const double* set_abundances, int64_t n_clusters) {
  double total = 0.0;
  int64_t row_base = 0, set_base = 0, slot_base = 0;
  for (int64_t c = 0; c < n_clusters; ++c) {
    for (int64_t s = 0; s < n_sets[c]; ++s) {
      const int64_t len = set_lens[set_base + s];
      for (int64_t j = 0; j < len; ++j) {
        const double ab = set_abundances[slot_base + j];
        const double eff = effs[row_base + set_ids[slot_base + j]];
        if (eff > 0.0) total += ab / eff;
      }
      slot_base += len;
    }
    set_base += n_sets[c];
    row_base += n_paths[c];
  }
  return total;
}

// Compose row text for <prefix>.txt (per-path marginalised) and
// <prefix>_joint.txt (per-set) in one threaded pass.  names_fixed is a
// row-major fixed-width (NUL-padded) name table over all path rows in
// cluster order; set_ids are cluster-local path indices.
void rpvg_compose_hapjoint_rows(
    const uint8_t* names_fixed, int64_t name_width, const int64_t* lengths,
    const double* effs, const int64_t* cids, const int64_t* n_paths,
    const int64_t* n_sets, const int64_t* set_lens,
    const double* set_posteriors, const int64_t* set_ids,
    const double* set_abundances, int64_t n_clusters, int64_t ploidy,
    double min_posterior, double total_transcript_count, int32_t digits,
    int32_t n_threads, uint8_t** out_hap, int64_t* out_hap_len,
    uint8_t** out_joint, int64_t* out_joint_len) {
  // Per-cluster bases (prefix sums) so workers are independent.
  std::vector<int64_t> row_base(n_clusters + 1), set_base(n_clusters + 1),
      slot_base(n_clusters + 1);
  {
    int64_t rows = 0, sets = 0, slots = 0;
    for (int64_t c = 0; c < n_clusters; ++c) {
      row_base[c] = rows;
      set_base[c] = sets;
      slot_base[c] = slots;
      rows += n_paths[c];
      sets += n_sets[c];
      for (int64_t s = 0; s < n_sets[c]; ++s) slots += set_lens[set_base[c] + s];
    }
    row_base[n_clusters] = rows;
    set_base[n_clusters] = sets;
    slot_base[n_clusters] = slots;
  }

  std::vector<std::string> hap_chunks(n_clusters), joint_chunks(n_clusters);
  compose::parallel_for(n_clusters, n_threads, [&](int64_t c) {
      std::vector<double> read_counts, hap_probs;
      const int64_t P = n_paths[c];
      const int64_t rb = row_base[c];
      std::string& hap = hap_chunks[c];
      std::string& joint = joint_chunks[c];

      read_counts.assign(P, 0.0);
      hap_probs.assign(P, 0.0);

      int64_t slot = slot_base[c];
      for (int64_t s = set_base[c]; s < set_base[c] + n_sets[c]; ++s) {
        const int64_t len = set_lens[s];
        const double post = set_posteriors[s];
        // Marginalise: every slot's abundance adds to its path; the
        // posterior adds once per distinct path (slots sorted, so
        // "first or different from previous" marks distinct).
        for (int64_t j = 0; j < len; ++j) {
          const int64_t p = set_ids[slot + j];
          read_counts[p] += set_abundances[slot + j];
          if (j == 0 || p != set_ids[slot + j - 1]) hap_probs[p] += post;
        }
        // Joint row (min-posterior filter applies after the abundance
        // iterator was consumed, like the Python writer).
        if (post >= min_posterior) {
          for (int64_t j = 0; j < len; ++j) {
            compose::put_name(&joint, names_fixed, name_width,
                              rb + set_ids[slot + j]);
            joint.push_back('\t');
          }
          for (int64_t j = len; j < ploidy; ++j) joint.append(".\t", 2);
          compose::put_i64(&joint, cids[c]);
          joint.push_back('\t');
          compose::put_g(&joint, post, digits);
          for (int64_t j = 0; j < len; ++j) {
            const double count = set_abundances[slot + j];
            const double eff = effs[rb + set_ids[slot + j]];
            const double tpm =
                eff > 0.0 ? count / eff / total_transcript_count * 1e6 : 0.0;
            joint.push_back('\t');
            compose::put_g(&joint, count, digits);
            joint.push_back('\t');
            compose::put_g(&joint, tpm, digits);
          }
          for (int64_t j = len; j < ploidy; ++j) joint.append("\t0\t0", 4);
          joint.push_back('\n');
        }
        slot += len;
      }

      for (int64_t p = 0; p < P; ++p) {
        const double eff = effs[rb + p];
        const double tpm = eff > 0.0
            ? read_counts[p] / eff / total_transcript_count * 1e6
            : 0.0;
        compose::put_name(&hap, names_fixed, name_width, rb + p);
        hap.push_back('\t');
        compose::put_i64(&hap, cids[c]);
        hap.push_back('\t');
        compose::put_i64(&hap, lengths[rb + p]);
        hap.push_back('\t');
        compose::put_g(&hap, eff, digits);
        hap.push_back('\t');
        compose::put_g(&hap, hap_probs[p], digits);
        hap.push_back('\t');
        compose::put_g(&hap, read_counts[p], digits);
        hap.push_back('\t');
        compose::put_g(&hap, tpm, digits);
        hap.push_back('\n');
      }
  });

  compose::concat_chunks(hap_chunks, out_hap, out_hap_len);
  compose::concat_chunks(joint_chunks, out_joint, out_joint_len);
}

}  // extern "C"

// ---------------------------------------------------------------------
// Raw-entry byte gather (speed path behind ColumnarFragments.gather_blob):
// copy n entries' byte ranges into a contiguous blob.  The numpy fancy-
// index equivalent materialises an int64 index array 8x the payload.

extern "C" {

void rpvg_gather_blob(const uint8_t* data, const int64_t* starts,
                      const int64_t* lens, const int64_t* out_starts,
                      int64_t n, uint8_t* out, int32_t n_threads) {
  const int32_t threads =
      std::max(1, std::min<int32_t>(n_threads, std::max<int64_t>(1, n)));
  auto copy_range = [&](int32_t t) {
    const int64_t begin = n * t / threads;
    const int64_t end = n * (t + 1) / threads;
    for (int64_t e = begin; e < end; ++e) {
      std::memcpy(out + out_starts[e], data + starts[e],
                  static_cast<size_t>(lens[e]));
    }
  };
  if (threads == 1) {
    copy_range(0);
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(copy_range, t);
    for (auto& th : pool) th.join();
  }
}

}  // extern "C"

// ---------------------------------------------------------------------
// Columnar composition of AbundanceEstimatesWriter rows (reference
// threaded_output_writer.cpp:283-343) for the transcripts/strains
// models: after reset(P, 1) every group set is the singleton of its
// path, so a row is (name, cid, length, eff, count, tpm) per path.

extern "C" {

void rpvg_compose_abundance_rows(
    const uint8_t* names_fixed, int64_t name_width, const int64_t* lengths,
    const double* effs, const double* abundances, const int64_t* cids,
    const int64_t* n_paths, int64_t n_clusters,
    double total_transcript_count, int32_t digits, int32_t n_threads,
    uint8_t** out, int64_t* out_len) {
  std::vector<int64_t> row_base(n_clusters + 1);
  {
    int64_t rows = 0;
    for (int64_t c = 0; c < n_clusters; ++c) {
      row_base[c] = rows;
      rows += n_paths[c];
    }
    row_base[n_clusters] = rows;
  }

  std::vector<std::string> chunks(n_clusters);
  compose::parallel_for(n_clusters, n_threads, [&](int64_t c) {
      std::string& text = chunks[c];
      const int64_t rb = row_base[c];
      for (int64_t p = 0; p < n_paths[c]; ++p) {
        const double eff = effs[rb + p];
        const double count = abundances[rb + p];
        const double tpm = eff > 0.0
            ? count / eff / total_transcript_count * 1e6
            : 0.0;
        compose::put_name(&text, names_fixed, name_width, rb + p);
        text.push_back('\t');
        compose::put_i64(&text, cids[c]);
        text.push_back('\t');
        compose::put_i64(&text, lengths[rb + p]);
        text.push_back('\t');
        compose::put_g(&text, eff, digits);
        text.push_back('\t');
        compose::put_g(&text, count, digits);
        text.push_back('\t');
        compose::put_g(&text, tpm, digits);
        text.push_back('\n');
      }
  });

  compose::concat_chunks(chunks, out, out_len);
}

// Sequential per-path TPM normaliser twin for singleton-set models
// (same addition order as compute_tpm_normalizer over singletons).
double rpvg_tpm_normalizer_perpath(const double* effs,
                                   const double* abundances, int64_t n) {
  double total = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    if (effs[i] > 0.0) total += abundances[i] / effs[i];
  }
  return total;
}

}  // extern "C"

extern "C" {

// Posterior-weighted combination for slots whose task EMs ran on the
// device (bounded-EM escalation / area handoffs): replays the exact
// combine tail of rpvg_nested_diploid_infer (reference
// inferPathSubsetAbundance :608-750) from externally-supplied per-task
// EM results, so deferred slots need no per-slot Python.  Output
// buffer: [per-slot n_sets i64][per-slot noise f64][sets_total i64]
// [set_lens i64][ids_total i64][set_ids i64][set_posteriors f64]
// [set_abundances f64].
uint8_t* rpvg_nested_combine(
    const int64_t* gid_concat, const int64_t* gid_offsets,
    const double* totals, int64_t n_slots, const int64_t* n_tasks,
    const double* subset_prob, const int64_t* n_col,
    const int64_t* collapsed, const int64_t* mult,
    const int64_t* col_offsets,  // per task, into collapsed/mult/em_counts
    const double* em_counts, const double* em_noise, int32_t n_threads,
    int64_t* out_len) {
  struct SlotOut {
    std::vector<int64_t> set_lens;
    std::vector<int64_t> set_ids;
    std::vector<double> set_posteriors;
    std::vector<double> set_abundances;
    double noise_count = 0.0;
  };
  std::vector<SlotOut> slots(n_slots);
  std::vector<int64_t> task_offsets(n_slots + 1, 0);
  for (int64_t b = 0; b < n_slots; ++b) {
    task_offsets[b + 1] = task_offsets[b] + n_tasks[b];
  }

  std::atomic<int64_t> next{0};
  auto worker = [&]() {
    std::vector<std::vector<int64_t>> ge_keys;
    std::vector<double> ge_post;
    std::vector<std::vector<double>> ge_abund;
    std::map<std::vector<int64_t>, size_t> ge_index;
    CombineScratch combine_scratch;
    for (;;) {
      int64_t b = next.fetch_add(1);
      if (b >= n_slots) return;
      SlotOut& out = slots[b];
      const int64_t* gid = gid_concat + gid_offsets[b];
      const double total_count = totals[b];
      ge_keys.clear();
      ge_post.clear();
      ge_abund.clear();
      ge_index.clear();
      double sum_hap = 0.0;
      double noise_combined = 0.0;
      for (int64_t t = task_offsets[b]; t < task_offsets[b + 1]; ++t) {
        const double sp = subset_prob[t];
        sum_hap += sp;
        noise_combined += em_noise[t] * sp;
        const int64_t base = col_offsets[t];
        const int64_t nc = n_col[t];
        combine_task_into(collapsed + base, mult + base, nc,
                          em_counts + base, sp, gid, combine_scratch,
                          ge_keys, ge_post, ge_abund, ge_index);
      }
      noise_combined += (1.0 - sum_hap) * total_count;
      out.noise_count = noise_combined;
      for (size_t s = 0; s < ge_keys.size(); ++s) {
        out.set_lens.push_back(static_cast<int64_t>(ge_keys[s].size()));
        out.set_ids.insert(out.set_ids.end(), ge_keys[s].begin(),
                           ge_keys[s].end());
        out.set_posteriors.push_back(ge_post[s]);
        out.set_abundances.insert(out.set_abundances.end(),
                                  ge_abund[s].begin(), ge_abund[s].end());
      }
    }
  };

  int32_t threads = std::max(1, (int32_t)n_threads);
  if (threads == 1 || n_slots <= 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t2 = 0; t2 < threads; ++t2) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  int64_t sets_total = 0, ids_total = 0;
  for (const auto& s : slots) {
    sets_total += static_cast<int64_t>(s.set_lens.size());
    ids_total += static_cast<int64_t>(s.set_ids.size());
  }
  const size_t total_bytes =
      n_slots * 16 + 16 + sets_total * 16 + ids_total * 16;
  auto* buf = static_cast<uint8_t*>(std::malloc(total_bytes));
  size_t off = 0;
  auto put_i64 = [&](int64_t v) { std::memcpy(buf + off, &v, 8); off += 8; };
  for (const auto& s : slots) put_i64(static_cast<int64_t>(s.set_lens.size()));
  for (const auto& s : slots) { std::memcpy(buf + off, &s.noise_count, 8); off += 8; }
  put_i64(sets_total);
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.set_lens.data(), s.set_lens.size() * 8);
    off += s.set_lens.size() * 8;
  }
  put_i64(ids_total);
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.set_ids.data(), s.set_ids.size() * 8);
    off += s.set_ids.size() * 8;
  }
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.set_posteriors.data(), s.set_posteriors.size() * 8);
    off += s.set_posteriors.size() * 8;
  }
  for (const auto& s : slots) {
    std::memcpy(buf + off, s.set_abundances.data(), s.set_abundances.size() * 8);
    off += s.set_abundances.size() * 8;
  }
  *out_len = static_cast<int64_t>(off);
  return buf;
}

}  // extern "C"

// ------------------------------------------------- cross-shard merge

extern "C" {

// Deduplicate the columnar dumps of N worker-process shards (the
// multi-worker fragment pass, rpvg_tpu/parallel/multihost.py).  Entries
// are keyed by their canonical raw serialization minus the embedded
// 8-byte count prefix; counts for identical keys sum; the merged order
// is the global first-seen scan order (shard-major, entry order within
// a shard) — exactly the Python keying loop this replaces, which cost
// ~1.1s at bench scale against ~30ms here.
//
// Parallel plan: one pass over all entries precomputes a 64-bit FNV-1a
// key hash (threaded by ranges); then `merge_shards` threads each own
// the keys whose hash lands on them and dedup independently in scan
// order; finally the per-hash-shard winners are re-sorted by global
// first-seen position.
//
// Outputs (caller-allocated at capacity sum(n_entries)):
//   out_shard[i], out_entry[i] — first-seen (shard, entry) per merged
//   entry, out_counts[i] — summed count.  Returns the merged count.
int64_t rpvg_merge_columnar_shards(
    const uint8_t** datas, const int64_t** raw_bounds,
    const int64_t** id_bounds,
    const int64_t* n_entries, int64_t n_shards, int32_t n_threads,
    int32_t* out_shard, int64_t* out_entry, int64_t* out_counts,
    int64_t* out_raw_lens, int64_t* out_id_lens) {
  int64_t total = 0;
  std::vector<int64_t> shard_offsets(n_shards + 1, 0);
  for (int64_t s = 0; s < n_shards; ++s) {
    shard_offsets[s + 1] = shard_offsets[s] + n_entries[s];
  }
  total = shard_offsets[n_shards];
  if (total == 0) return 0;
  if (n_threads <= 0) n_threads = 1;

  // Phase 0: per-entry key hash + count, threaded over global ranges.
  std::vector<uint64_t> hashes(total);
  std::vector<uint64_t> counts(total);
  {
    auto hash_range = [&](int64_t g0, int64_t g1) {
      int64_t s = 0;
      for (int64_t g = g0; g < g1; ++g) {
        while (g >= shard_offsets[s + 1]) ++s;
        const int64_t e = g - shard_offsets[s];
        const int64_t start = raw_bounds[s][e];
        const int64_t end = raw_bounds[s][e + 1];
        const uint8_t* p = datas[s] + start;
        uint64_t count;
        std::memcpy(&count, p, 8);
        counts[g] = count;
        uint64_t h = 1469598103934665603ull;  // FNV-1a offset basis
        for (const uint8_t* k = p + 8; k < datas[s] + end; ++k) {
          h ^= *k;
          h *= 1099511628211ull;
        }
        hashes[g] = h;
      }
    };
    const int32_t workers =
        static_cast<int32_t>(std::min<int64_t>(n_threads, total));
    if (workers <= 1) {
      hash_range(0, total);
    } else {
      std::vector<std::thread> pool;
      pool.reserve(workers);
      const int64_t chunk = (total + workers - 1) / workers;
      for (int32_t w = 0; w < workers; ++w) {
        const int64_t g0 = std::min<int64_t>(total, w * chunk);
        const int64_t g1 = std::min<int64_t>(total, g0 + chunk);
        if (g0 < g1) pool.emplace_back(hash_range, g0, g1);
      }
      for (auto& th : pool) th.join();
    }
  }

  // Phase 1: hash-sharded dedup in global scan order.
  const int32_t merge_shards =
      std::max(1, std::min<int32_t>(n_threads, 16));
  struct Winner {
    int64_t first_g;
    uint64_t count;
  };
  std::vector<std::vector<Winner>> shard_winners(merge_shards);
  {
    auto dedup_shard = [&](int32_t ms) {
      auto& winners = shard_winners[ms];
      winners.reserve(total / merge_shards + 16);
      std::unordered_map<std::string_view, size_t> seen;
      seen.reserve(total / merge_shards + 16);
      for (int64_t s = 0; s < n_shards; ++s) {
        const uint8_t* base = datas[s];
        const int64_t* rb = raw_bounds[s];
        for (int64_t e = 0; e < n_entries[s]; ++e) {
          const int64_t g = shard_offsets[s] + e;
          if (static_cast<int32_t>(hashes[g] %
                                   static_cast<uint64_t>(merge_shards)) != ms)
            continue;
          std::string_view key(
              reinterpret_cast<const char*>(base + rb[e] + 8),
              static_cast<size_t>(rb[e + 1] - rb[e] - 8));
          auto [it, inserted] = seen.emplace(key, winners.size());
          if (inserted) {
            winners.push_back({g, counts[g]});
          } else {
            winners[it->second].count += counts[g];
          }
        }
      }
    };
    if (merge_shards == 1) {
      dedup_shard(0);
    } else {
      std::vector<std::thread> pool;
      pool.reserve(merge_shards);
      for (int32_t ms = 0; ms < merge_shards; ++ms)
        pool.emplace_back(dedup_shard, ms);
      for (auto& th : pool) th.join();
    }
  }

  // Phase 2: restore the global first-seen order.
  std::vector<Winner> merged;
  {
    size_t n = 0;
    for (const auto& w : shard_winners) n += w.size();
    merged.reserve(n);
    for (auto& w : shard_winners) {
      merged.insert(merged.end(), w.begin(), w.end());
      w.clear();
      w.shrink_to_fit();
    }
  }
  std::sort(merged.begin(), merged.end(),
            [](const Winner& a, const Winner& b) { return a.first_g < b.first_g; });

  for (size_t i = 0; i < merged.size(); ++i) {
    const int64_t g = merged[i].first_g;
    int64_t s = 0;
    while (g >= shard_offsets[s + 1]) ++s;
    const int64_t e = g - shard_offsets[s];
    out_shard[i] = static_cast<int32_t>(s);
    out_entry[i] = e;
    out_counts[i] = static_cast<int64_t>(merged[i].count);
    out_raw_lens[i] = raw_bounds[s][e + 1] - raw_bounds[s][e];
    out_id_lens[i] = id_bounds[s][e + 1] - id_bounds[s][e];
  }
  return static_cast<int64_t>(merged.size());
}

// Gather the merged entries' raw bytes (count prefix rewritten to the
// merged totals), located-id runs and anchors into the caller's
// preallocated output arrays — the second half of the cross-shard
// merge, replacing the numpy repeat/fancy-index gathers (~0.9s at
// bench scale).  out_raw_bounds / out_id_bounds are the exclusive
// cumsums of the lens the merge call returned.
void rpvg_gather_merged_columnar(
    const uint8_t** datas, const int64_t** raw_bounds,
    const int64_t** id_bounds, const int64_t** all_ids,
    const int64_t** anchors,
    const int32_t* sel_shard, const int64_t* sel_entry,
    const int64_t* merged_counts,
    const int64_t* out_raw_bounds, const int64_t* out_id_bounds,
    int64_t n, int32_t n_threads,
    uint8_t* out_blob, int64_t* out_ids, int64_t* out_anchors) {
  if (n == 0) return;
  if (n_threads <= 0) n_threads = 1;
  auto gather_range = [&](int64_t i0, int64_t i1) {
    for (int64_t i = i0; i < i1; ++i) {
      const int32_t s = sel_shard[i];
      const int64_t e = sel_entry[i];
      const int64_t rstart = raw_bounds[s][e];
      const int64_t rlen = raw_bounds[s][e + 1] - rstart;
      uint8_t* dst = out_blob + out_raw_bounds[i];
      std::memcpy(dst, datas[s] + rstart, static_cast<size_t>(rlen));
      const uint64_t count = static_cast<uint64_t>(merged_counts[i]);
      std::memcpy(dst, &count, 8);  // rewrite the embedded count field
      const int64_t istart = id_bounds[s][e];
      const int64_t ilen = id_bounds[s][e + 1] - istart;
      std::memcpy(out_ids + out_id_bounds[i], all_ids[s] + istart,
                  static_cast<size_t>(ilen) * 8);
      out_anchors[i] = anchors[s][e];
    }
  };
  const int32_t workers =
      static_cast<int32_t>(std::min<int64_t>(n_threads, n));
  if (workers <= 1) {
    gather_range(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(workers);
  const int64_t chunk = (n + workers - 1) / workers;
  for (int32_t w = 0; w < workers; ++w) {
    const int64_t i0 = std::min<int64_t>(n, w * chunk);
    const int64_t i1 = std::min<int64_t>(n, i0 + chunk);
    if (i0 < i1) pool.emplace_back(gather_range, i0, i1);
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Connected components over the clustering edge list (path_clusters.cpp's
// striped-mutex BFS in the reference; clustering.py's vectorised sweep built
// on scipy here).  Plain weighted union-find with path halving: the scipy
// route pays a full COO->CSR conversion (sort + duplicate sum) that costs
// ~10x the labelling itself at bench scale.  Labels are the component roots;
// the Python caller re-labels by smallest member id, so any stable root
// choice is equivalent.

extern "C" {

void rpvg_union_find(const int64_t* edge_u, const int64_t* edge_v,
                     int64_t n_edges, int64_t n_nodes, int64_t* out_labels) {
  std::vector<int64_t> parent(static_cast<size_t>(n_nodes));
  for (int64_t i = 0; i < n_nodes; ++i) parent[static_cast<size_t>(i)] = i;
  std::vector<uint8_t> rank_(static_cast<size_t>(n_nodes), 0);
  auto find = [&parent](int64_t x) {
    while (parent[static_cast<size_t>(x)] != x) {
      parent[static_cast<size_t>(x)] =
          parent[static_cast<size_t>(parent[static_cast<size_t>(x)])];
      x = parent[static_cast<size_t>(x)];
    }
    return x;
  };
  for (int64_t e = 0; e < n_edges; ++e) {
    int64_t a = find(edge_u[e]);
    int64_t b = find(edge_v[e]);
    if (a == b) continue;
    if (rank_[static_cast<size_t>(a)] < rank_[static_cast<size_t>(b)]) std::swap(a, b);
    parent[static_cast<size_t>(b)] = a;
    if (rank_[static_cast<size_t>(a)] == rank_[static_cast<size_t>(b)])
      ++rank_[static_cast<size_t>(a)];
  }
  for (int64_t i = 0; i < n_nodes; ++i) out_labels[i] = find(i);
}

}  // extern "C"
