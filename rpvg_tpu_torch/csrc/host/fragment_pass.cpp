// fragment_pass — the `.rpa` fragment pass as one native call.
//
// The library's translation unit: it compiles rpvg_native.cpp (the
// port's copy of the JAX package's host kernels, kept byte for byte) and
// adds a second engine for the common case, one process reading an
// `.rpa` file:
//
//   * a reader (the calling thread) reads the file's blocks, up to four
//     in flight, and numbers each block's fragments in file order;
//   * `-t` persistent workers take chunks of 64 fragments from the
//     blocks as they arrive;
//   * each worker projects a fragment with FlatFinder, the pinned
//     Finder's search step for step (the same candidates, order, scores
//     and condensing), keeping alignment records, search paths and
//     outputs in a bump arena that is rewound per fragment, and shares
//     positions and node paths copy-on-write instead of copying them at
//     every branch;
//   * a fragment's condensed path list is serialized into a reused
//     buffer, hashed once, and counted in the worker's open-addressing
//     table (key bytes in one per-worker byte array);
//   * the dump merges the tables in hash shards on threads, orders the
//     entries by first-seen ordinal, locates path ids through a
//     position -> sequence table, and writes the columns of
//     rpvg_indexer_dump_located.
//
// Both engines write the same bytes; tests/test_torch_flat_pass.py holds
// them together.  Everything else (non-`.rpa` input, sharded passes, the
// per-fragment API) stays on rpvg_native.cpp's engine.

#include "rpvg_native.cpp"

#include <condition_variable>
#include <cstdio>
#include <deque>
#include <memory>
#include <mutex>

namespace {
namespace flat {

// ------------------------------------------------------------------ arena

// Bump allocator with stable pointers: blocks are kept across resets, so
// a worker's steady state allocates nothing from the heap.
class Arena {
 public:
  void* raw(size_t bytes) {
    bytes = (bytes + 7) & ~static_cast<size_t>(7);
    while (cur_ < blocks_.size()) {
      Block& b = blocks_[cur_];
      if (b.used + bytes <= b.size) {
        void* p = b.data.get() + b.used;
        b.used += bytes;
        return p;
      }
      ++cur_;
    }
    const size_t size = std::max(kBlockBytes, bytes);
    blocks_.push_back(Block{std::unique_ptr<uint8_t[]>(new uint8_t[size]), size, bytes});
    cur_ = blocks_.size() - 1;
    capacity_ += size;
    return blocks_.back().data.get();
  }

  template <typename T>
  T* alloc(size_t n) {
    return static_cast<T*>(raw(n * sizeof(T)));
  }

  void reset() {
    const size_t touched = std::min(cur_ + 1, blocks_.size());
    for (size_t i = 0; i < touched; ++i) blocks_[i].used = 0;
    cur_ = 0;
  }

  size_t capacity() const { return capacity_; }

 private:
  struct Block {
    std::unique_ptr<uint8_t[]> data;
    size_t size;
    size_t used;
  };
  static constexpr size_t kBlockBytes = 1 << 18;
  std::vector<Block> blocks_;
  size_t cur_ = 0;
  size_t capacity_ = 0;
};

// ------------------------------------------------------------- alignments

struct FPath {
  const MappingRec* m = nullptr;
  int32_t n = 0;
};

struct FSubpath {
  FPath path;
  const int32_t* next = nullptr;
  int32_t n_next = 0;
  int32_t n_connections = 0;
  int32_t score = 0;
};

// AlignmentRec over arena (or input) memory; `n_quality` 0 = no qualities.
struct FAln {
  int32_t seq_len = 0;
  int32_t mapq = 0;
  int32_t allelic_mapq = -1;
  int32_t score = 0;
  bool is_multipath = false;
  bool disconnected = false;
  FPath path;
  const FSubpath* subpaths = nullptr;
  int32_t n_subpaths = 0;
  const int32_t* starts = nullptr;
  int32_t n_starts = 0;
  const uint8_t* quality = nullptr;
  int32_t n_quality = 0;
};

FPath read_fpath(Reader* r, Arena* arena) {
  FPath path;
  path.n = r->get<int32_t>();
  MappingRec* m = arena->alloc<MappingRec>(path.n);
  for (int32_t i = 0; i < path.n; ++i) {
    m[i].node = r->get<int64_t>();
    m[i].offset = r->get<int32_t>();
    m[i].to_length = r->get<int32_t>();
    m[i].from_length = r->get<int32_t>();
    m[i].first_edit_from = r->get<int32_t>();
    m[i].first_edit_to = r->get<int32_t>();
    m[i].last_edit_from = r->get<int32_t>();
    m[i].last_edit_to = r->get<int32_t>();
  }
  path.m = m;
  return path;
}

FAln read_faln(Reader* r, bool is_multipath, Arena* arena) {
  FAln aln;
  aln.is_multipath = is_multipath;
  aln.seq_len = r->get<int32_t>();
  aln.mapq = r->get<int32_t>();
  aln.allelic_mapq = r->get<int32_t>();
  aln.disconnected = r->get<uint8_t>() != 0;
  if (r->get<uint8_t>()) {
    aln.quality = r->ptr;
    aln.n_quality = aln.seq_len;
    r->ptr += aln.seq_len;
  }
  if (!is_multipath) {
    aln.score = r->get<int32_t>();
    aln.path = read_fpath(r, arena);
    return aln;
  }
  aln.n_subpaths = r->get<int32_t>();
  aln.n_starts = r->get<int32_t>();
  int32_t* starts = arena->alloc<int32_t>(aln.n_starts);
  for (int32_t i = 0; i < aln.n_starts; ++i) starts[i] = r->get<int32_t>();
  aln.starts = starts;
  FSubpath* subpaths = arena->alloc<FSubpath>(aln.n_subpaths);
  for (int32_t i = 0; i < aln.n_subpaths; ++i) {
    FSubpath& sp = subpaths[i];
    sp.score = r->get<int32_t>();
    sp.n_connections = r->get<int32_t>();
    sp.n_next = r->get<int32_t>();
    int32_t* next = arena->alloc<int32_t>(sp.n_next);
    for (int32_t j = 0; j < sp.n_next; ++j) next[j] = r->get<int32_t>();
    sp.next = next;
    sp.path = read_fpath(r, arena);
  }
  aln.subpaths = subpaths;
  return aln;
}

FPath rc_fpath(const FPath& p, const Index& idx, Arena* arena) {
  FPath out;
  out.n = p.n;
  MappingRec* m = arena->alloc<MappingRec>(p.n);
  for (int32_t i = 0; i < p.n; ++i) m[i] = rc_mapping(p.m[p.n - 1 - i], idx);
  out.m = m;
  return out;
}

// rc_alignment's record: allelic_mapq left absent and every subpath's
// connections dropped, as there.
FAln rc_faln(const FAln& a, const Index& idx, Arena* arena) {
  FAln out;
  out.seq_len = a.seq_len;
  out.mapq = a.mapq;
  out.score = a.score;
  out.is_multipath = a.is_multipath;
  out.disconnected = a.disconnected;
  if (a.n_quality > 0) {
    uint8_t* q = arena->alloc<uint8_t>(a.n_quality);
    for (int32_t i = 0; i < a.n_quality; ++i) q[i] = a.quality[a.n_quality - 1 - i];
    out.quality = q;
    out.n_quality = a.n_quality;
  }
  if (!a.is_multipath) {
    out.path = rc_fpath(a.path, idx, arena);
    return out;
  }

  const int32_t n = a.n_subpaths;
  // reverse_edges[j]: the sources i of edges i -> j, in descending i.
  int32_t* in_count = arena->alloc<int32_t>(n + 1);
  std::fill(in_count, in_count + n + 1, 0);
  int32_t n_reverse_starts = 0;
  for (int32_t i = 0; i < n; ++i) {
    const FSubpath& sp = a.subpaths[i];
    if (sp.n_next > 0 || sp.n_connections > 0) {
      for (int32_t k = 0; k < sp.n_next; ++k) in_count[sp.next[k] + 1] += 1;
    } else {
      ++n_reverse_starts;
    }
  }
  for (int32_t j = 0; j < n; ++j) in_count[j + 1] += in_count[j];
  int32_t* edge_src = arena->alloc<int32_t>(in_count[n]);
  int32_t* fill = arena->alloc<int32_t>(n);
  std::copy(in_count, in_count + n, fill);
  int32_t* reverse_starts = arena->alloc<int32_t>(n_reverse_starts);
  int32_t n_rs = 0;
  for (int32_t i = n - 1; i >= 0; --i) {
    const FSubpath& sp = a.subpaths[i];
    if (sp.n_next > 0 || sp.n_connections > 0) {
      for (int32_t k = 0; k < sp.n_next; ++k) edge_src[fill[sp.next[k]]++] = i;
    } else {
      reverse_starts[n_rs++] = i;
    }
  }

  FSubpath* subpaths = arena->alloc<FSubpath>(n);
  for (int32_t i = n - 1; i >= 0; --i) {
    const FSubpath& sp = a.subpaths[i];
    FSubpath& rc_sp = subpaths[n - 1 - i];
    rc_sp = FSubpath();
    rc_sp.path = rc_fpath(sp.path, idx, arena);
    rc_sp.score = sp.score;
    rc_sp.n_connections = 0;
  }
  for (int32_t i = 0; i < n; ++i) {
    const int32_t j = n - 1 - i;
    const int32_t count = in_count[j + 1] - in_count[j];
    int32_t* next = arena->alloc<int32_t>(count);
    for (int32_t k = 0; k < count; ++k) next[k] = n - 1 - edge_src[in_count[j] + k];
    subpaths[i].next = next;
    subpaths[i].n_next = count;
  }
  out.subpaths = subpaths;
  out.n_subpaths = n;
  if (a.n_starts > 0) {
    int32_t* starts = arena->alloc<int32_t>(n_rs);
    for (int32_t k = 0; k < n_rs; ++k) starts[k] = n - 1 - reverse_starts[k];
    out.starts = starts;
    out.n_starts = n_rs;
  }
  return out;
}

int32_t faln_score(const ScoreTables& tables, const FAln& aln, bool score_not_qual,
                   int32_t start, int32_t length) {
  if (score_not_qual || aln.n_quality == 0) return length;
  int32_t score = 0;
  for (int32_t i = start; i < start + length; ++i) score += tables.match_scores[aln.quality[i]];
  return score;
}

int32_t faln_optimal_score(const ScoreTables& tables, const FAln& aln, bool score_not_qual) {
  if (score_not_qual || aln.n_quality == 0) {
    return aln.seq_len * MATCH_SCORE + 2 * FULL_LENGTH_BONUS;
  }
  int32_t score = faln_score(tables, aln, score_not_qual, 0, aln.seq_len);
  score += tables.bonuses[aln.quality[0]] + tables.bonuses[aln.quality[aln.n_quality - 1]];
  return score;
}

void update_left_softclip(AlignmentStats* s, const FPath& path) {
  const MappingRec& m = path.m[0];
  s->left_softclip = (m.first_edit_from == 0) ? m.first_edit_to : 0;
}

void update_right_softclip(AlignmentStats* s, const FPath& path) {
  const MappingRec& m = path.m[path.n - 1];
  s->right_softclip = (m.last_edit_from == 0) ? m.last_edit_to : 0;
}

// ----------------------------------------------------------- search paths

// SearchPath with its node path and occurrence positions in arena (or
// index) memory.  A buffer it does not own is shared with another path or
// is the index's own: the first change copies it (copy-on-write).
struct Path {
  int64_t* path = nullptr;
  uint32_t len = 0;
  uint32_t cap = 0;
  int64_t* pos = nullptr;
  uint32_t npos = 0;
  bool path_owned = false;
  bool pos_owned = false;
  uint8_t n_stats = 0;
  int64_t node = ENDMARKER;
  int32_t start_offset = 0;
  int32_t end_offset = 0;
  int32_t insert_length = 0;
  AlignmentStats stats[2];

  void clear() {
    len = 0;
    node = ENDMARKER;
    npos = 0;
  }

  AlignmentStats& back() { return stats[n_stats - 1]; }
  const AlignmentStats& back() const { return stats[n_stats - 1]; }
  const AlignmentStats& front() const { return stats[0]; }

  int32_t alignment_length() const {
    if (n_stats == 1) return stats[0].length - stats[0].clipped_total();
    return front().length + back().length - front().clipped_total() - back().clipped_total();
  }

  int32_t fragment_length() const {
    if (n_stats == 1) {
      if (insert_length == 0) return stats[0].length;
      return stats[0].length + insert_length - stats[0].clipped_right();
    }
    return front().length + back().length + insert_length - front().clipped_right() -
           back().clipped_left();
  }

  int32_t score_sum() const {
    int32_t total = 0;
    for (uint8_t i = 0; i < n_stats; ++i) total += stats[i].adjusted_score();
    return total;
  }

  double min_optimal_score_fraction(const int32_t* optimal) const {
    double frac = 1.0;
    for (uint8_t i = 0; i < n_stats; ++i) {
      frac = std::min(frac, stats[i].adjusted_score() / static_cast<double>(optimal[i]));
    }
    return std::max(0.0, frac);
  }

  bool is_complete() const {
    for (uint8_t i = 0; i < n_stats; ++i) {
      if (!stats[i].complete) return false;
    }
    return true;
  }

  bool is_internal() const {
    for (uint8_t i = 0; i < n_stats; ++i) {
      if (stats[i].is_internal()) return true;
    }
    return false;
  }

  bool same_path(const Path& o) const {
    return len == o.len && std::equal(path, path + len, o.path);
  }

  bool sort_greater(const Path& o) const {
    if (len != o.len) return len > o.len;
    for (uint32_t i = 0; i < len; ++i) {
      if (path[i] != o.path[i]) return path[i] > o.path[i];
    }
    if (insert_length != o.insert_length) return insert_length > o.insert_length;
    int32_t s1 = score_sum(), s2 = o.score_sum();
    if (s1 != s2) return s1 > s2;
    if (n_stats != o.n_stats) return n_stats > o.n_stats;
    for (uint8_t i = 0; i < n_stats; ++i) {
      int c = stats[i].compare(o.stats[i]);
      if (c) return c > 0;
    }
    if (start_offset != o.start_offset) return start_offset > o.start_offset;
    return end_offset > o.end_offset;
  }
};

// A second handle on `src`'s buffers: neither owns them afterwards.
Path share(Path* src) {
  src->path_owned = false;
  src->pos_owned = false;
  return *src;
}

struct Out {
  int64_t node;
  const int64_t* pos;
  uint32_t npos;
  bool is_simple;
  int32_t mapq;
  int32_t score_sum;
  int32_t align_length;
  int32_t frag_length;
};

bool positions_greater(const Out& a, const Out& b) {
  return std::lexicographical_compare(b.pos, b.pos + b.npos, a.pos, a.pos + a.npos);
}

bool positions_equal(const Out& a, const Out& b) {
  return a.npos == b.npos && std::equal(a.pos, a.pos + a.npos, b.pos);
}

// ------------------------------------------------------------------ finder

class FlatFinder {
 public:
  FlatFinder(const Index& index, const Params& params, const ScoreTables& tables, Arena* arena)
      : idx_(index), p_(params), tables_(tables), a_(arena) {}

  // Finder::find_single; the result stays valid until the arena rewinds.
  std::vector<Out>& find_single(const FAln& aln) {
    outs_.clear();
    found_.clear();
    if (!has_path(aln) || !starts_in_graph(aln)) return outs_;
    if (p_.library_type == 1) {
      find_single_search_paths(&found_, aln);
    } else if (p_.library_type == 2) {
      FAln rc = rc_faln(aln, idx_, a_);
      find_single_search_paths(&found_, rc);
    } else {
      find_single_search_paths(&found_, aln);
      if (!idx_.bidirectional) {
        FAln rc = rc_faln(aln, idx_, a_);
        find_single_search_paths(&found_, rc);
      }
    }
    finalize(&found_, aln.disconnected, resolve(aln));
    return outs_;
  }

  // Finder::find_paired.
  std::vector<Out>& find_paired(const FAln& aln_1, const FAln& aln_2) {
    outs_.clear();
    found_.clear();
    if (!has_path(aln_1) || !has_path(aln_2)) return outs_;
    if (!starts_in_graph(aln_1) || !starts_in_graph(aln_2)) return outs_;
    if (p_.library_type == 1) {
      FAln rc2 = rc_faln(aln_2, idx_, a_);
      find_paired_search_paths(&found_, aln_1, rc2);
    } else if (p_.library_type == 2) {
      FAln rc1 = rc_faln(aln_1, idx_, a_);
      find_paired_search_paths(&found_, aln_2, rc1);
    } else {
      FAln rc2 = rc_faln(aln_2, idx_, a_);
      find_paired_search_paths(&found_, aln_1, rc2);
      if (!idx_.bidirectional) {
        FAln rc1 = rc_faln(aln_1, idx_, a_);
        find_paired_search_paths(&found_, aln_2, rc1);
      }
    }
    bool is_multimap = aln_1.disconnected || aln_2.disconnected;
    int32_t mapq = std::min(resolve(aln_1), resolve(aln_2));
    finalize(&found_, is_multimap, mapq);
    return outs_;
  }

  uint64_t extend_ns = 0;
  uint64_t pair_ns = 0;

 private:
  const Index& idx_;
  const Params& p_;
  const ScoreTables& tables_;
  Arena* a_;

  // Scratch kept across fragments (capacity only).
  std::vector<Path> found_, cands_, start_cands_, end_cands_, extended_;
  std::vector<std::pair<Path, int32_t>> stack_;
  std::vector<std::pair<Path, bool>> seeds_;
  std::vector<std::pair<int32_t, int32_t>> start_order_, next_order_;
  std::vector<std::pair<int64_t, int32_t>> memo_;
  std::vector<int64_t> end_start_nodes_;
  std::vector<std::vector<uint32_t>> end_start_lists_;
  std::vector<std::pair<int64_t, uint32_t>> end_counts_;  // open addressing
  std::vector<uint32_t> end_counts_used_;
  std::vector<std::vector<int64_t>> depth_scratch_;
  struct DfsFrame {
    int64_t e;
    int64_t edge_begin;
    int64_t blocked;
    // Undo info for this node's entry (unused on the seed frame).
    int32_t saved_end_offset = 0;
    int64_t saved_node = 0;
    int64_t saved_blocked = 0;
    int64_t* saved_pos = nullptr;
    uint32_t saved_npos = 0;
  };
  std::vector<DfsFrame> frames_;
  std::vector<Out> outs_;

  int32_t resolve(const FAln& aln) const {
    if (p_.use_allelic_mapq && aln.allelic_mapq >= 0) return std::min(aln.allelic_mapq, aln.mapq);
    return aln.mapq;
  }

  static bool has_path(const FAln& aln) {
    return aln.is_multipath ? aln.n_subpaths > 0 : aln.path.n > 0;
  }

  bool starts_in_graph(const FAln& aln) const {
    if (aln.is_multipath) {
      for (int32_t k = 0; k < aln.n_starts; ++k) {
        const FPath& path = aln.subpaths[aln.starts[k]].path;
        if (path.n == 0 || !idx_.has_node_id(path.m[0].node >> 1)) return false;
      }
      return true;
    }
    return idx_.has_node_id(aln.path.m[0].node >> 1);
  }

  // ------------------------------------------------- storage primitives
  void push_node(Path* p, int64_t node) {
    if (!p->path_owned || p->len == p->cap) {
      const uint32_t cap = std::max<uint32_t>(8, p->len * 2);
      int64_t* grown = a_->alloc<int64_t>(cap);
      if (p->len) std::memcpy(grown, p->path, p->len * sizeof(int64_t));
      p->path = grown;
      p->cap = cap;
      p->path_owned = true;
    }
    p->path[p->len++] = node;
  }

  // index_find: the index's own occurrence list, shared.
  void find(Path* p, int64_t node) const {
    p->node = node;
    p->npos = 0;
    p->pos_owned = false;
    if (node >= 0 && node <= idx_.max_enc_node) {
      const int64_t begin = idx_.occ_offsets[node];
      const int64_t end = idx_.occ_offsets[node + 1];
      p->pos = const_cast<int64_t*>(idx_.occ_positions.data() + begin);
      p->npos = static_cast<uint32_t>(end - begin);
    }
  }

  // index_extend.
  void extend(Path* p, int64_t node) {
    if (p->npos == 0) {
      p->node = node;
      return;
    }
    int64_t* dst = p->pos_owned ? p->pos : a_->alloc<int64_t>(p->npos);
    const int64_t* concat = idx_.concat.data();
    uint32_t out = 0;
    for (uint32_t i = 0; i < p->npos; ++i) {
      const int64_t next = p->pos[i] + 1;
      if (concat[next] == node) dst[out++] = next;
    }
    p->pos = dst;
    p->npos = out;
    p->pos_owned = true;
    p->node = node;
  }

  // ------------------------------------------------ node-level extension
  void extend_with_mapping(Path* sp, const MappingRec& mapping) {
    int64_t cur_node = mapping.node;
    if (sp->len == 0) {
      push_node(sp, cur_node);
      find(sp, cur_node);
      sp->start_offset = mapping.offset;
    } else {
      const int64_t last = sp->path[sp->len - 1];
      bool is_cycle_visit = last == cur_node && mapping.offset != sp->end_offset;
      if (is_cycle_visit && mapping.offset != 0) {
        sp->clear();
      } else if (last != cur_node || is_cycle_visit) {
        push_node(sp, cur_node);
        if (sp->npos) extend(sp, cur_node);
      }
    }
    sp->end_offset = mapping.offset + mapping.from_length;
  }

  // ------------------------------------------------ path-level extension
  void extend_with_path(std::vector<Path>* paths, const FPath& graph_path, bool is_first_path,
                        bool is_last_path, const FAln& aln, bool add_internal_start) {
    if (is_first_path) update_left_softclip(&paths->front().back(), graph_path);
    if (is_last_path) update_right_softclip(&paths->front().back(), graph_path);

    size_t last_internal_start_idx = 0;
    size_t first_main_idx = 0;
    int32_t seq_length = aln.seq_len;
    size_t n_mappings = graph_path.n;

    for (size_t m_idx = 0; m_idx < n_mappings; ++m_idx) {
      const MappingRec& mapping = graph_path.m[m_idx];
      int64_t cur_node = mapping.node;
      int32_t mapping_read_length = mapping.to_length;
      bool is_last_mapping = is_last_path && m_idx == n_mappings - 1;

      bool have_main = false;
      Path main_path;
      if (p_.max_partial_offset > 0 && paths->front().len != 0) {
        while (first_main_idx < paths->size()) {
          Path& candidate = (*paths)[first_main_idx];
          if (candidate.npos == 0 || candidate.back().internal_end.is_internal) {
            ++first_main_idx;
            continue;
          }
          if (seq_length - candidate.back().length <= candidate.back().internal_end.max_offset) {
            main_path = share(&candidate);
            have_main = true;
          }
          break;
        }
      }

      for (auto& sp : *paths) {
        AlignmentStats& stats = sp.back();
        if (stats.internal_end.is_internal) {
          int32_t delta = mapping_read_length;
          if (is_last_mapping) delta -= stats.right_softclip;
          stats.internal_end.offset += delta;
          if (stats.internal_end.offset <= p_.max_partial_offset) {
            stats.internal_end.penalty +=
                faln_score(tables_, aln, p_.score_not_qual, stats.length, delta);
          } else {
            sp.clear();
          }
        } else {
          extend_with_mapping(&sp, mapping);
        }
      }

      if (have_main) {
        const Path& candidate = (*paths)[first_main_idx];
        if (main_path.npos > candidate.npos) {
          AlignmentStats& mstats = main_path.back();
          mstats.internal_end.is_internal = true;
          mstats.internal_end.offset = mapping_read_length;
          if (is_last_mapping) mstats.internal_end.offset -= mstats.right_softclip;
          if (mstats.internal_end.offset <= p_.max_partial_offset) {
            mstats.internal_end_next_node = cur_node;
            mstats.internal_end.penalty = faln_score(tables_, aln, p_.score_not_qual,
                                                     mstats.length, mstats.internal_end.offset);
            paths->push_back(main_path);
          }
        }
      }

      if (p_.max_partial_offset > 0 && add_internal_start &&
          (*paths)[last_internal_start_idx].len > 1 &&
          !(*paths)[last_internal_start_idx].back().internal_end.is_internal) {
        const AlignmentStats& anchor = (*paths)[last_internal_start_idx].back();
        if (anchor.length <= anchor.internal_start.max_offset) {
          AlignmentStats new_stats = anchor;
          new_stats.internal_start.is_internal = true;
          new_stats.internal_start.offset = new_stats.length - new_stats.left_softclip;
          if (new_stats.internal_start.offset <= p_.max_partial_offset) {
            Path fresh;
            extend_with_mapping(&fresh, mapping);
            if (fresh.npos != 0 && fresh.npos > (*paths)[last_internal_start_idx].npos) {
              new_stats.internal_start.penalty =
                  faln_score(tables_, aln, p_.score_not_qual, new_stats.left_softclip,
                             new_stats.internal_start.offset);
              fresh.stats[0] = new_stats;
              fresh.n_stats = 1;
              paths->push_back(fresh);
              last_internal_start_idx = paths->size() - 1;
            }
          }
        }
      }

      for (auto& sp : *paths) sp.back().length += mapping_read_length;
    }
  }

  // --------------------------------------------- single-path extension
  void extend_with_single_path(std::vector<Path>* paths, const FAln& aln) {
    int32_t optimal = faln_optimal_score(tables_, aln, p_.score_not_qual);
    int32_t seq_length = aln.seq_len;

    paths->assign(1, Path());
    AlignmentStats stats;
    stats.score = aln.score;
    stats.internal_start.max_offset = std::min(p_.max_partial_offset, seq_length);
    stats.internal_end.max_offset = std::min(p_.max_partial_offset, seq_length);
    (*paths)[0].stats[0] = stats;
    (*paths)[0].n_stats = 1;

    extend_with_path(paths, aln.path, true, true, aln, true);

    int32_t max_score = 0;
    for (auto& sp : *paths) {
      if ((sp.is_internal() || !p_.est_missing_noise_prob) && sp.npos == 0) continue;
      if (sp.back().length == seq_length) {
        sp.back().complete = true;
        max_score = std::max(max_score, sp.score_sum());
      }
    }
    for (auto& sp : *paths) {
      if (sp.back().complete && max_score - sp.score_sum() > p_.max_score_diff) {
        sp.back().complete = false;
      }
    }
    if (below_best_score_filter(*paths, optimal)) paths->push_back(error_sentinel(seq_length));
  }

  // ----------------------------------------------- multipath extension
  void extend_with_multipath(std::vector<Path>* out, const FAln& aln) {
    int32_t optimal = faln_optimal_score(tables_, aln, p_.score_not_qual);
    int32_t seq_length = aln.seq_len;
    out->clear();

    int32_t min_right_softclip = INT32_MAX_V;
    int32_t max_right_softclip = 0;
    AlignmentStats probe;
    for (int32_t s = 0; s < aln.n_subpaths; ++s) {
      const FSubpath& sp = aln.subpaths[s];
      if (sp.n_next == 0) {
        update_right_softclip(&probe, sp.path);
        min_right_softclip = std::min(min_right_softclip, probe.right_softclip);
        max_right_softclip = std::max(max_right_softclip, probe.right_softclip);
      }
    }

    start_order_.clear();
    for (int32_t k = 0; k < aln.n_starts; ++k) {
      start_order_.push_back({aln.subpaths[aln.starts[k]].score, aln.starts[k]});
    }
    std::sort(start_order_.rbegin(), start_order_.rend());

    memo_.clear();
    int32_t best_align_score = static_cast<int32_t>(std::floor(optimal * p_.min_best_score_filter));
    bool has_right_bonus = min_right_softclip == 0;

    for (size_t k = 0; k < start_order_.size(); ++k) {
      const int32_t start_idx = start_order_[k].second;
      Path init;
      AlignmentStats init_stats;
      update_left_softclip(&probe, aln.subpaths[start_idx].path);
      init_stats.internal_start.max_offset =
          std::min(probe.left_softclip + p_.max_partial_offset, seq_length);
      init_stats.internal_end.max_offset =
          std::min(max_right_softclip + p_.max_partial_offset, seq_length);
      init.stats[0] = init_stats;
      init.n_stats = 1;
      best_align_score =
          multipath_dfs(out, init, aln, start_idx, best_align_score, has_right_bonus);
    }

    for (auto& sp : *out) {
      if (best_align_score - sp.score_sum() > p_.max_score_diff) sp.back().complete = false;
    }
    if (below_best_score_filter(*out, optimal)) out->push_back(error_sentinel(seq_length));
  }

  int32_t multipath_dfs(std::vector<Path>* out, const Path& init, const FAln& aln,
                        int32_t start_idx, int32_t best_align_score, bool has_right_bonus) {
    int32_t seq_length = aln.seq_len;
    stack_.clear();
    stack_.push_back({init, start_idx});

    while (!stack_.empty()) {
      Path sp = stack_.back().first;
      int32_t subpath_idx = stack_.back().second;
      stack_.pop_back();

      const FSubpath& subpath = aln.subpaths[subpath_idx];
      AlignmentStats& stats = sp.back();
      stats.score += subpath.score;

      int32_t subpath_length = 0;
      for (int32_t k = 0; k < subpath.path.n; ++k) subpath_length += subpath.path.m[k].to_length;
      int32_t seq_left = seq_length - (stats.length + subpath_length);

      int32_t max_score = stats.score + seq_left;
      if (has_right_bonus && subpath.n_next > 0) max_score += FULL_LENGTH_BONUS;
      if (best_align_score - max_score > p_.max_score_diff) continue;

      bool add_internal_start = false;
      if (p_.max_partial_offset > 0 && stats.length <= stats.internal_start.max_offset) {
        add_internal_start = true;
        int64_t memo_key = (static_cast<int64_t>(subpath_idx) << 32) |
                           static_cast<uint32_t>(stats.length - stats.left_softclip);
        bool seen = false;
        for (auto& [key, score] : memo_) {
          if (key != memo_key) continue;
          seen = true;
          if (stats.score <= score) add_internal_start = false;
          else score = stats.score;
          break;
        }
        if (!seen) memo_.push_back({memo_key, stats.score});
      } else if (sp.npos == 0) {
        if (best_align_score - max_score > MAX_NOISE_SCORE_DIFF) continue;
      }

      extended_.clear();
      extended_.push_back(sp);
      extend_with_path(&extended_, subpath.path, subpath_idx == start_idx, subpath.n_next == 0,
                       aln, add_internal_start);

      for (auto& ext : extended_) {
        if (ext.npos == 0) {
          if (ext.is_internal()) continue;
          if (!p_.est_missing_noise_prob && p_.max_partial_offset == 0) continue;
          if (!p_.est_missing_noise_prob &&
              ext.back().length > ext.back().internal_start.max_offset)
            continue;
        }
        if (subpath.n_next > 0) {
          next_order_.clear();
          for (int32_t k = 0; k < subpath.n_next; ++k) {
            next_order_.push_back({aln.subpaths[subpath.next[k]].score, subpath.next[k]});
          }
          std::sort(next_order_.begin(), next_order_.end());
          // One successor takes the path over; several share it.
          if (next_order_.size() > 1) share(&ext);
          for (const auto& [nscore, next_idx] : next_order_) stack_.push_back({ext, next_idx});
        } else if (subpath.n_connections == 0) {
          best_align_score = std::max(best_align_score, ext.score_sum());
          ext.back().complete = true;
          out->push_back(ext);
        }
      }
    }
    return best_align_score;
  }

  void extend_with_alignment(std::vector<Path>* out, const FAln& aln) {
    if (aln.is_multipath) {
      extend_with_multipath(out, aln);
    } else {
      extend_with_single_path(out, aln);
    }
  }

  // ------------------------------------------------- single-read search
  void find_single_search_paths(std::vector<Path>* out, const FAln& aln) {
    std::vector<Path>& candidates = cands_;
    extend_with_alignment(&candidates, aln);
    if (candidates.empty()) return;

    std::sort(candidates.begin(), candidates.end(),
              [](const Path& a, const Path& b) { return a.sort_greater(b); });

    double joint_score = LOWEST;
    double joint_empty_score = LOWEST;

    for (size_t i = 0; i < candidates.size(); ++i) {
      Path& sp = candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.same_path(candidates[i - 1])) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.npos == 0) {
        joint_empty_score = add_log(joint_empty_score, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) joint_score = add_log(joint_score, score_sum * SCORE_LOG_BASE);
      out->push_back(sp);
      // Finder moves the path out, and the next candidate compares with
      // the empty node path it leaves.
      sp.len = 0;
    }

    Path noise;
    noise.stats[0].score =
        double_to_int((joint_score - joint_empty_score) / NOISE_SCORE_LOG_BASE);
    noise.n_stats = 1;
    out->push_back(noise);
  }

  // -------------------------------------------------- paired-end search
  uint32_t* end_count_slot(int64_t node, bool insert) {
    const size_t mask = end_counts_.size() - 1;
    size_t i = static_cast<size_t>((static_cast<uint64_t>(node) * 0x9e3779b97f4a7c15ull) >> 32) & mask;
    for (;;) {
      auto& slot = end_counts_[i];
      if (slot.first == node) return &slot.second;
      if (slot.first == INT64_MIN) {
        if (!insert) return nullptr;
        slot.first = node;
        slot.second = 0;
        end_counts_used_.push_back(static_cast<uint32_t>(i));
        return &slot.second;
      }
      i = (i + 1) & mask;
    }
  }

  void reset_end_counts(size_t expected) {
    for (uint32_t i : end_counts_used_) end_counts_[i].first = INT64_MIN;
    end_counts_used_.clear();
    size_t want = 64;
    while (want < expected * 2) want <<= 1;
    if (end_counts_.size() < want) end_counts_.assign(want, {INT64_MIN, 0});
  }

  const std::vector<uint32_t>* end_start_list(int64_t node) const {
    for (size_t k = 0; k < end_start_nodes_.size(); ++k) {
      if (end_start_nodes_[k] == node) return &end_start_lists_[k];
    }
    return nullptr;
  }

  void find_paired_search_paths(std::vector<Path>* out, const FAln& start_aln,
                                const FAln& end_aln) {
    uint64_t t0 = prof_on() ? prof_now() : 0;
    extend_with_alignment(&start_cands_, start_aln);
    extend_with_alignment(&end_cands_, end_aln);
    if (prof_on()) {
      uint64_t t1 = prof_now();
      extend_ns += t1 - t0;
      t0 = t1;
    }
    struct PairProf {
      uint64_t t0;
      uint64_t* sink;
      ~PairProf() {
        if (sink) *sink += prof_now() - t0;
      }
    } pair_prof{t0, prof_on() ? &pair_ns : nullptr};
    std::vector<Path>& start_candidates = start_cands_;
    std::vector<Path>& end_candidates = end_cands_;
    if (start_candidates.empty() || end_candidates.empty()) return;

    auto cmp = [](const Path& a, const Path& b) { return a.sort_greater(b); };
    std::sort(start_candidates.begin(), start_candidates.end(), cmp);
    std::sort(end_candidates.begin(), end_candidates.end(), cmp);

    int32_t end_seq_length = end_aln.seq_len;

    uint32_t num_unique_end = 0;
    int32_t end_max_left_softclip = 0;
    size_t end_nodes_total = 0;
    for (const auto& sp : end_candidates) end_nodes_total += sp.len;
    reset_end_counts(end_nodes_total);
    end_start_nodes_.clear();
    for (auto& list : end_start_lists_) list.clear();

    double joint_end = LOWEST, joint_empty_end = LOWEST;

    for (size_t i = 0; i < end_candidates.size(); ++i) {
      const Path& sp = end_candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.same_path(end_candidates[i - 1])) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.npos == 0) {
        joint_empty_end = add_log(joint_empty_end, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) joint_end = add_log(joint_end, score_sum * SCORE_LOG_BASE);
      ++num_unique_end;
      end_max_left_softclip = std::max(end_max_left_softclip, sp.back().left_softclip);
      for (uint32_t k = 0; k < sp.len; ++k) *end_count_slot(sp.path[k], true) += 1;
      const int64_t first = sp.path[0];
      size_t slot = 0;
      while (slot < end_start_nodes_.size() && end_start_nodes_[slot] != first) ++slot;
      if (slot == end_start_nodes_.size()) {
        end_start_nodes_.push_back(first);
        if (end_start_lists_.size() < end_start_nodes_.size()) end_start_lists_.emplace_back();
      }
      end_start_lists_[slot].push_back(static_cast<uint32_t>(i));
    }

    bool end_alignment_in_cycle = false;
    for (int64_t node : end_start_nodes_) {
      if (node >= 0 && node <= idx_.max_enc_node && idx_.node_in_cycle[node]) {
        end_alignment_in_cycle = true;
        break;
      }
    }

    seeds_.clear();
    double joint_start = LOWEST, joint_empty_start = LOWEST;

    for (size_t i = 0; i < start_candidates.size(); ++i) {
      Path& sp = start_candidates[i];
      if (!sp.is_complete()) continue;
      if (i > 0 && sp.same_path(start_candidates[i - 1])) continue;

      int32_t score_sum = sp.score_sum();
      if (sp.npos == 0) {
        joint_empty_start = add_log(joint_empty_start, score_sum * SCORE_LOG_BASE);
        continue;
      }
      if (!sp.is_internal()) joint_start = add_log(joint_start, score_sum * SCORE_LOG_BASE);

      int32_t node_length = idx_.node_length(sp.node >> 1);

      for (size_t k = 0; k < end_start_nodes_.size(); ++k) {
        const int64_t end_start_node = end_start_nodes_[k];
        for (uint32_t pos = 0; pos < sp.len; ++pos) {
          if (sp.path[pos] != end_start_node) continue;
          for (uint32_t end_idx : end_start_lists_[k]) {
            merge_paired(out, sp, pos, end_candidates[end_idx]);
          }
        }
      }

      Path extended = share(&sp);
      extended.insert_length += node_length - sp.end_offset;
      extended.end_offset = node_length;
      seeds_.push_back({extended, false});
    }

    // Finder's in-place DFS over panel out-edges, seeds and edges in
    // reverse; the working path's positions live in per-depth buffers.
    auto visit = [&](Path& cur, bool try_complete, int64_t* blocked_out) -> bool {
      if (try_complete) {
        const std::vector<uint32_t>* list = end_start_list(cur.path[cur.len - 1]);
        if (list != nullptr) {
          for (uint32_t end_idx : *list) {
            Path merged = cur;
            merged.insert_length -= merged.end_offset;
            merged.end_offset = end_candidates[end_idx].start_offset;
            merged.insert_length += merged.end_offset;
            merge_paired(out, merged, cur.len - 1, end_candidates[end_idx]);
          }
        }
      }
      if (!end_alignment_in_cycle) {
        const uint32_t* count = end_count_slot(cur.path[cur.len - 1], false);
        if (count != nullptr && *count == num_unique_end) return false;
      }
      if (cur.fragment_length() + end_seq_length - end_max_left_softclip >
          p_.max_pair_frag_length) {
        return false;
      }
      *blocked_out = cur.back().internal_end_next_node;
      return true;
    };

    std::vector<DfsFrame>& frames = frames_;
    for (size_t s = seeds_.size(); s-- > 0;) {
      Path& cur = seeds_[s].first;
      int64_t blocked;
      if (!visit(cur, seeds_[s].second, &blocked)) continue;
      frames.clear();
      frames.push_back({idx_.edge_offsets[cur.node + 1] - 1, idx_.edge_offsets[cur.node], blocked});
      while (!frames.empty()) {
        const size_t depth = frames.size() - 1;
        DfsFrame& f = frames.back();
        if (f.e < f.edge_begin) {
          if (depth > 0) {
            cur.back().internal_end_next_node = f.saved_blocked;
            cur.insert_length -= cur.end_offset;
            cur.end_offset = f.saved_end_offset;
            cur.len -= 1;
            cur.node = f.saved_node;
            cur.pos = f.saved_pos;
            cur.npos = f.saved_npos;
          }
          frames.pop_back();
          continue;
        }
        const int64_t succ = idx_.edge_targets[f.e--];
        if (succ == ENDMARKER || succ == f.blocked) continue;
        if (depth_scratch_.size() <= depth) depth_scratch_.resize(depth + 1);
        std::vector<int64_t>& buf = depth_scratch_[depth];
        if (buf.size() < cur.npos) buf.resize(cur.npos);
        uint32_t n_next = 0;
        {
          const int64_t* concat = idx_.concat.data();
          for (uint32_t i = 0; i < cur.npos; ++i) {
            const int64_t next = cur.pos[i] + 1;
            if (concat[next] == succ) buf[n_next++] = next;
          }
        }
        if (n_next == 0) continue;
        DfsFrame child;
        child.saved_end_offset = cur.end_offset;
        child.saved_node = cur.node;
        child.saved_blocked = f.blocked;
        child.saved_pos = cur.pos;
        child.saved_npos = cur.npos;
        cur.pos = buf.data();
        cur.npos = n_next;
        cur.pos_owned = false;
        cur.node = succ;
        push_node(&cur, succ);
        cur.end_offset = idx_.node_length(succ >> 1);
        cur.insert_length += cur.end_offset;
        cur.back().internal_end_next_node = ENDMARKER;
        int64_t child_blocked;
        if (visit(cur, true, &child_blocked)) {
          child.e = idx_.edge_offsets[succ + 1] - 1;
          child.edge_begin = idx_.edge_offsets[succ];
          child.blocked = child_blocked;
          frames.push_back(child);  // f may dangle after this push
        } else {
          cur.back().internal_end_next_node = child.saved_blocked;
          cur.insert_length -= cur.end_offset;
          cur.end_offset = child.saved_end_offset;
          cur.len -= 1;
          cur.node = child.saved_node;
          cur.pos = child.saved_pos;
          cur.npos = child.saved_npos;
        }
      }
    }
    seeds_.clear();

    Path noise;
    noise.stats[0].score = double_to_int((joint_start - joint_empty_start) / NOISE_SCORE_LOG_BASE);
    noise.stats[1].score = double_to_int((joint_end - joint_empty_end) / NOISE_SCORE_LOG_BASE);
    noise.n_stats = 2;
    out->push_back(noise);
  }


  // Finder::merge_paired on a copy of `main_in`, pushed onto `out` when
  // the merge keeps a live search state within the fragment-length limit;
  // the checks read `main_in`'s buffers, and only a kept merge copies them.
  void merge_paired(std::vector<Path>* out, const Path& main_in, size_t main_start_idx,
                    const Path& second) {
    if (second.len < main_in.len - main_start_idx) return;
    Path m = main_in;
    const AlignmentStats& main_stats = main_in.back();
    const AlignmentStats& second_stats = second.front();

    if (main_start_idx == 0) {
      int32_t main_left = m.start_offset - main_stats.clipped_left();
      int32_t second_left = second.start_offset - second_stats.clipped_left();
      if (second_left < main_left) return;
    }

    size_t second_idx = 0;
    size_t idx = main_start_idx;
    size_t n_main = m.len;
    while (idx < n_main) {
      if (m.path[idx] != second.path[second_idx]) return;
      if (idx + 1 == n_main) {
        if (second_idx + 1 == second.len) {
          int32_t main_right = m.end_offset + main_stats.clipped_right();
          int32_t second_right = second.end_offset + second_stats.clipped_right();
          if (second_right < main_right) return;
          if (idx == 0) {
            m.insert_length += std::max(m.start_offset, second.start_offset) -
                               std::min(m.end_offset, second.end_offset);
          } else if (second_idx == 0) {
            m.insert_length += second.start_offset - std::min(m.end_offset, second.end_offset);
          } else {
            m.insert_length -= std::min(m.end_offset, second.end_offset);
          }
        } else if (second_idx == 0) {
          m.insert_length += second.start_offset - m.end_offset;
        } else {
          m.insert_length -= m.end_offset;
        }
      } else if (second_idx == 0) {
        int32_t node_length = idx_.node_length(m.path[idx] >> 1);
        if (idx == 0) {
          m.insert_length -= node_length - std::max(m.start_offset, second.start_offset);
        } else {
          m.insert_length -= node_length - second.start_offset;
        }
      } else {
        m.insert_length -= idx_.node_length(m.path[idx] >> 1);
      }
      ++idx;
      ++second_idx;
    }

    m.end_offset = second.end_offset;
    m.stats[m.n_stats++] = second.front();
    // What Finder keeps: a live search state after the second read's
    // remaining nodes, within the fragment-length limit.
    if (m.npos == 0 || m.fragment_length() > p_.max_pair_frag_length) return;

    const uint32_t remaining = second.len - static_cast<uint32_t>(second_idx);
    int64_t* pos = a_->alloc<int64_t>(m.npos);
    uint32_t npos = m.npos;
    if (remaining == 0) {
      std::memcpy(pos, m.pos, npos * sizeof(int64_t));
    } else {
      const int64_t* concat = idx_.concat.data();
      const int64_t* src = m.pos;
      for (uint32_t k = 0; k < remaining; ++k) {
        const int64_t node = second.path[second_idx + k];
        uint32_t kept = 0;
        for (uint32_t i = 0; i < npos; ++i) {
          const int64_t next = src[i] + 1;
          if (concat[next] == node) pos[kept++] = next;
        }
        if (kept == 0) return;
        npos = kept;
        src = pos;
      }
      m.node = second.path[second.len - 1];
    }
    int64_t* path = a_->alloc<int64_t>(m.len + remaining);
    std::memcpy(path, m.path, m.len * sizeof(int64_t));
    std::memcpy(path + m.len, second.path + second_idx, remaining * sizeof(int64_t));
    m.path = path;
    m.len += remaining;
    m.cap = m.len;
    m.path_owned = true;
    m.pos = pos;
    m.npos = npos;
    m.pos_owned = true;
    out->push_back(m);
  }

  // -------------------------------------------------------------- misc
  bool below_best_score_filter(const std::vector<Path>& paths, int32_t optimal) const {
    double best = 0.0;
    for (const auto& sp : paths) {
      if (sp.is_complete()) best = std::max(best, sp.min_optimal_score_fraction(&optimal));
    }
    return best < p_.min_best_score_filter;
  }

  Path error_sentinel(int32_t seq_length) {
    Path sentinel;
    push_node(&sentinel, ENDMARKER);
    sentinel.stats[0].score = INT32_MAX_V;
    sentinel.stats[0].length = seq_length;
    sentinel.stats[0].complete = true;
    sentinel.n_stats = 1;
    return sentinel;
  }

  void finalize(std::vector<Path>* search_paths, bool is_multimap, int32_t mapq) {
    outs_.clear();
    if (search_paths->empty()) return;

    bool is_simple = !is_multimap;
    if (is_simple) {
      int32_t frag_length = 0;
      for (const auto& sp : *search_paths) {
        if (sp.is_complete()) {
          if (sp.is_internal() || (frag_length > 0 && sp.fragment_length() != frag_length)) {
            is_simple = false;
            break;
          }
          frag_length = sp.fragment_length();
        }
      }
    }

    double noise_prob = 1.0;
    for (const auto& sp : *search_paths) {
      if (sp.npos == 0) {
        double non_noise_prob = 1.0;
        for (uint8_t i = 0; i < sp.n_stats; ++i) {
          double read_error_prob = 1.0 / (1.0 + std::exp(sp.stats[i].score * NOISE_SCORE_LOG_BASE));
          non_noise_prob *= 1.0 - read_error_prob;
        }
        noise_prob = std::min(noise_prob, 1.0 - non_noise_prob);
      } else if (sp.is_complete()) {
        outs_.push_back(Out{sp.node, sp.pos, sp.npos, is_simple, mapq, sp.score_sum(),
                            sp.alignment_length(), sp.fragment_length()});
      }
    }

    std::sort(outs_.begin(), outs_.end(), [](const Out& a, const Out& b) {
      if (a.node != b.node) return a.node > b.node;
      if (!positions_equal(a, b)) return positions_greater(a, b);
      if (a.is_simple != b.is_simple) return a.is_simple > b.is_simple;
      if (a.mapq != b.mapq) return a.mapq > b.mapq;
      if (a.frag_length != b.frag_length) return a.frag_length > b.frag_length;
      if (a.align_length != b.align_length) return a.align_length > b.align_length;
      return a.score_sum > b.score_sum;
    });

    if (!outs_.empty()) {
      Out noise{ENDMARKER, nullptr, 0, is_simple, mapq, 0, 0, 0};
      const double eps = std::numeric_limits<double>::epsilon() * 100;
      bool is_zero = noise_prob == 0.0 ||
                     std::abs(noise_prob - 0.0) < std::abs(std::min(noise_prob, 0.0)) * eps;
      noise.score_sum =
          is_zero ? INT32_MIN_V : double_to_int(std::log(noise_prob) / NOISE_SCORE_LOG_BASE);
      outs_.push_back(noise);
    }
  }
};

// ------------------------------------------------------------ dedup table

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint64_t fmix64(uint64_t k) {
  k ^= k >> 33;
  k *= 0xff51afd7ed558ccdull;
  k ^= k >> 33;
  k *= 0xc4ceb9fe1a85ec53ull;
  k ^= k >> 33;
  return k;
}

uint64_t hash_key(const uint8_t* p, size_t n) {
  uint64_t h = 0x9e3779b97f4a7c15ull;
  size_t i = 0;
  for (; i + 8 <= n; i += 8) {
    uint64_t w;
    std::memcpy(&w, p + i, 8);
    w *= 0x87c37b91114253d5ull;
    w = rotl64(w, 31);
    w *= 0x4cf5ad432745937full;
    h ^= w;
    h = rotl64(h, 27) * 5 + 0x52dce729;
  }
  if (i < n) {
    uint64_t w = 0;
    std::memcpy(&w, p + i, n - i);
    w *= 0x87c37b91114253d5ull;
    w = rotl64(w, 31);
    w *= 0x4cf5ad432745937full;
    h ^= w;
  }
  return fmix64(h ^ n);
}

// One distinct fragment list: its key's hash, the fragments that gave it,
// the first of them in file order, and where its key bytes are.
struct Slot {
  uint64_t hash;
  uint64_t count;  // 0 = empty
  uint64_t ord;
  uint64_t ref;  // offset into the table's bytes, or the address of the key
  uint64_t len;
};

// Open addressing over Slots, linear probing, at most half full.  A
// worker's table keeps its key bytes (`own`); a merge table refers to the
// workers'.
class Table {
 public:
  Table(size_t capacity, bool own) : own_(own) {
    size_t cap = 16;
    while (cap < capacity) cap <<= 1;
    slots_.assign(cap, Slot{0, 0, 0, 0, 0});
  }

  void add(const uint8_t* key, size_t len, uint64_t hash, uint64_t count, uint64_t ord) {
    if ((used_ + 1) * 2 > slots_.size()) grow();
    const size_t mask = slots_.size() - 1;
    for (size_t i = hash & mask;; i = (i + 1) & mask) {
      Slot& s = slots_[i];
      if (s.count == 0) {
        uint64_t ref = reinterpret_cast<uintptr_t>(key);
        if (own_) {
          ref = bytes_.size();
          bytes_.insert(bytes_.end(), key, key + len);
        }
        s = Slot{hash, count, ord, ref, len};
        ++used_;
        return;
      }
      if (s.hash == hash && s.len == len && std::memcmp(key_of(s), key, len) == 0) {
        s.count += count;
        s.ord = std::min(s.ord, ord);
        return;
      }
    }
  }

  const uint8_t* key_of(const Slot& s) const {
    return own_ ? bytes_.data() + s.ref : reinterpret_cast<const uint8_t*>(s.ref);
  }
  const std::vector<Slot>& slots() const { return slots_; }
  size_t size() const { return used_; }

 private:
  void grow() {
    std::vector<Slot> old(slots_.size() * 2, Slot{0, 0, 0, 0, 0});
    old.swap(slots_);
    const size_t mask = slots_.size() - 1;
    for (const Slot& s : old) {
      if (s.count == 0) continue;
      size_t i = s.hash & mask;
      while (slots_[i].count != 0) i = (i + 1) & mask;
      slots_[i] = s;
    }
  }

  bool own_;
  std::vector<Slot> slots_;
  std::vector<uint8_t> bytes_;
  size_t used_ = 0;
};

// ------------------------------------------------------------------- pass

struct Block {
  std::vector<uint8_t> payload;
  std::vector<const uint8_t*> offsets;  // per fragment, and the end
  int32_t n = 0;
  uint64_t ord_base = 0;
  int32_t next = 0;  // first fragment not yet handed out
  int32_t done = 0;
};

constexpr int32_t kStealChunk = 64;
constexpr size_t kBlocksInFlight = 4;

struct Worker {
  Worker(const Index& idx, const Params& params, const ScoreTables& tables, int64_t hist_size)
      : finder(idx, params, tables, &arena), table(1 << 14, true), histogram(hist_size, 0) {}

  Arena arena;
  FlatFinder finder;
  Table table;
  std::vector<int64_t> histogram;
  std::vector<uint8_t> key;
  uint64_t unaligned = 0;
  uint64_t wait_ns = 0;
  uint64_t project_ns = 0;  // thread-CPU, under RPVG_TPU_NATIVE_PROF
  uint64_t dedup_ns = 0;
};

// The pass's result, alive until rpvg_flat_free.
struct Pass {
  Params params;  // the workers' finders refer to these two
  ScoreTables tables;
  std::vector<std::unique_ptr<Worker>> workers;
  std::vector<int64_t> histogram;
  uint64_t unaligned = 0;
};

// rpvg_native's index_fragment into a worker's table: condense, count the
// fragment length, rewrite a unique hit, serialize, count the key.
void index_fragment(Worker* w, std::vector<Out>& paths, uint64_t ordinal, int32_t pre_loc,
                    bool is_single_end) {
  if (paths.empty()) {
    ++w->unaligned;
    return;
  }
  if (paths.size() > 2) {
    size_t kept = 1;
    for (size_t i = 1; i < paths.size(); ++i) {
      const Out& prev = paths[kept - 1];
      const Out& cur = paths[i];
      if (prev.node == cur.node && positions_equal(prev, cur) &&
          prev.frag_length == cur.frag_length) {
        continue;
      }
      paths[kept++] = cur;
    }
    paths.resize(kept);
  }

  Out& first = paths.front();
  if (!is_single_end && first.is_simple && first.mapq >= FRAG_LENGTH_MIN_MAPQ &&
      first.frag_length >= 0 &&
      first.frag_length < static_cast<int32_t>(w->histogram.size())) {
    w->histogram[first.frag_length] += 1;
  }
  if (paths.size() == 2) {
    first.score_sum = 1;
    first.align_length = 1;
    first.frag_length = pre_loc;
  }

  size_t bytes = 4;
  for (const Out& ap : paths) bytes += 12 + 8 * static_cast<size_t>(ap.npos) + 17;
  if (w->key.size() < bytes) w->key.resize(bytes);
  uint8_t* k = w->key.data();
  auto put = [&k](const void* src, size_t n) {
    std::memcpy(k, src, n);
    k += n;
  };
  const int32_t n_paths = static_cast<int32_t>(paths.size());
  put(&n_paths, 4);
  for (const Out& ap : paths) {
    const int32_t npos = static_cast<int32_t>(ap.npos);
    const uint8_t simple = ap.is_simple ? 1 : 0;
    put(&ap.node, 8);
    put(&npos, 4);
    if (npos) put(ap.pos, 8 * static_cast<size_t>(npos));
    put(&simple, 1);
    put(&ap.mapq, 4);
    put(&ap.score_sum, 4);
    put(&ap.align_length, 4);
    put(&ap.frag_length, 4);
  }
  w->table.add(w->key.data(), bytes, hash_key(w->key.data(), bytes), 1, ordinal);
}

// The reader's and the pool's shared state: the blocks read and not yet
// finished, in file order, at most kBlocksInFlight of them.
struct Feed {
  std::mutex mu;
  std::condition_variable work_ready;
  std::condition_variable room;
  std::deque<std::unique_ptr<Block>> live;
  size_t handing = 0;  // the first live block with fragments to hand out
  bool reader_done = false;

  // The next chunk, or false at the end of the input.
  bool take(Block** block, int32_t* begin, int32_t* end, uint64_t* wait_ns) {
    std::unique_lock<std::mutex> lock(mu);
    for (;;) {
      while (handing < live.size() && live[handing]->next == live[handing]->n) ++handing;
      if (handing < live.size()) {
        Block* b = live[handing].get();
        *block = b;
        *begin = b->next;
        *end = std::min(b->n, b->next + kStealChunk);
        b->next = *end;
        return true;
      }
      if (reader_done) return false;
      const uint64_t t0 = prof_wall();
      work_ready.wait(lock);
      *wait_ns += prof_wall() - t0;
    }
  }

  void finish(Block* b, int32_t n) {
    std::unique_ptr<Block> gone;  // freed outside the lock
    {
      std::lock_guard<std::mutex> lock(mu);
      b->done += n;
      if (b->done < b->n) return;
      for (size_t i = 0; i < live.size(); ++i) {
        if (live[i].get() != b) continue;
        gone = std::move(live[i]);
        live.erase(live.begin() + i);
        if (i < handing) --handing;
        break;
      }
    }
    room.notify_one();
  }
};

// Fragment offsets of a block payload (the pinned engine's prescan).
void prescan(Block* b) {
  if (b->payload.size() < 4) {
    b->n = 0;
    return;
  }
  Reader scan{b->payload.data(), b->payload.data() + b->payload.size()};
  b->n = scan.get<int32_t>();
  b->offsets.resize(static_cast<size_t>(b->n) + 1);
  for (int32_t f = 0; f < b->n; ++f) {
    b->offsets[f] = scan.ptr;
    uint8_t kind = scan.get<uint8_t>();
    skip_alignment(&scan, kind & 1);
    if (kind & 2) skip_alignment(&scan, kind & 1);
  }
  b->offsets[b->n] = scan.ptr;
}

void work(Worker* w, Feed* feed, int32_t pre_loc, bool is_single_end) {
  const bool prof = prof_on();
  Block* b;
  int32_t begin, end;
  while (feed->take(&b, &begin, &end, &w->wait_ns)) {
    Reader reader{b->offsets[begin], b->offsets[end]};
    for (int32_t f = begin; f < end; ++f) {
      const uint64_t ord = b->ord_base + static_cast<uint64_t>(f);
      w->arena.reset();
      uint8_t kind = reader.get<uint8_t>();
      bool is_multipath = kind & 1;
      FAln aln_1 = read_faln(&reader, is_multipath, &w->arena);
      const uint64_t t0 = prof ? prof_now() : 0;
      std::vector<Out>* found;
      if (kind & 2) {
        FAln aln_2 = read_faln(&reader, is_multipath, &w->arena);
        found = &w->finder.find_paired(aln_1, aln_2);
      } else {
        found = &w->finder.find_single(aln_1);
      }
      const uint64_t t1 = prof ? prof_now() : 0;
      index_fragment(w, *found, ord, pre_loc, is_single_end);
      if (prof) {
        w->project_ns += t1 - t0;
        w->dedup_ns += prof_now() - t1;
      }
    }
    feed->finish(b, end - begin);
  }
}

// Error codes of rpvg_flat_pass, in the order of io/rpa.RpaReader.blocks.
enum : int64_t {
  kOk = 0,
  kTruncatedHeader = 1,
  kCorruptLength = 2,
  kTruncatedBlock = 3,
  kUnreadable = 4,
};

}  // namespace flat
}  // namespace

extern "C" {

// The whole `.rpa` pass: read the file's blocks from `data_offset` (its
// header already checked by the caller) and project, condense and count
// every fragment on `iparams[7]` workers.  Returns the pass (for
// rpvg_flat_dump and rpvg_flat_free) and fills `stats`:
//   [0] error (0; 1 truncated block header; 2 negative block length;
//       3 truncated block; 4 unreadable file), [1] blocks, [2] payload
//   bytes, [3] the workers' peak arena bytes, [4] the reader's seconds in
//   reads, [5] the workers' mean seconds waiting for a block.
void* rpvg_flat_pass(void* index_handle, const char* path, int64_t data_offset,
                     const int32_t* iparams, double min_best_score_filter,
                     const int32_t* qual_match_scores, const int32_t* qual_bonuses,
                     int64_t hist_size, int32_t pre_loc, int32_t is_single_end,
                     double* stats) {
  using namespace flat;
  const Index& idx = *static_cast<Index*>(index_handle);
  auto* pass = new Pass();
  Params& params = pass->params;
  params.library_type = iparams[0];
  params.score_not_qual = iparams[1];
  params.max_pair_frag_length = iparams[2];
  params.max_partial_offset = iparams[3];
  params.est_missing_noise_prob = iparams[4];
  params.max_score_diff = iparams[5];
  params.use_allelic_mapq = iparams[6];
  params.min_best_score_filter = min_best_score_filter;
  const int32_t n_threads = std::max(1, iparams[7]);
  ScoreTables& tables = pass->tables;
  for (int i = 0; i < 256; ++i) {
    tables.match_scores[i] = qual_match_scores[i];
    tables.bonuses[i] = qual_bonuses[i];
  }

  for (int32_t t = 0; t < n_threads; ++t) {
    pass->workers.push_back(std::make_unique<Worker>(idx, params, tables, hist_size));
  }
  Feed feed;
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int32_t t = 0; t < n_threads; ++t) {
    pool.emplace_back(work, pass->workers[t].get(), &feed, pre_loc, is_single_end != 0);
  }

  // The reader: this thread.
  int64_t error = kOk;
  uint64_t blocks = 0, bytes = 0, read_ns = 0, prescan_ns = 0, ord = 0;
  std::FILE* file = std::fopen(path, "rb");
  if (file == nullptr || std::fseek(file, data_offset, SEEK_SET) != 0) error = kUnreadable;
  while (error == kOk) {
    {
      std::unique_lock<std::mutex> lock(feed.mu);
      feed.room.wait(lock, [&] { return feed.live.size() < kBlocksInFlight; });
    }
    const uint64_t t0 = prof_wall();
    uint8_t header[8];
    const size_t got = std::fread(header, 1, 8, file);
    if (got == 0) break;
    if (got != 8) {
      error = kTruncatedHeader;
      break;
    }
    int64_t length;
    std::memcpy(&length, header, 8);
    if (length < 0) {
      error = kCorruptLength;
      break;
    }
    auto block = std::make_unique<Block>();
    block->payload.resize(static_cast<size_t>(length));
    if (std::fread(block->payload.data(), 1, block->payload.size(), file) !=
        block->payload.size()) {
      error = kTruncatedBlock;
      break;
    }
    const uint64_t t1 = prof_wall();
    read_ns += t1 - t0;
    prescan(block.get());
    prescan_ns += prof_wall() - t1;
    block->ord_base = ord;
    ord += static_cast<uint64_t>(block->n);
    ++blocks;
    bytes += static_cast<uint64_t>(length);
    if (block->n == 0) continue;
    {
      std::lock_guard<std::mutex> lock(feed.mu);
      feed.live.push_back(std::move(block));
    }
    feed.work_ready.notify_all();
  }
  if (file != nullptr) std::fclose(file);
  {
    std::lock_guard<std::mutex> lock(feed.mu);
    feed.reader_done = true;
  }
  feed.work_ready.notify_all();
  for (auto& th : pool) th.join();

  pass->histogram.assign(hist_size, 0);
  uint64_t wait_ns = 0, arena_bytes = 0, distinct = 0, project_ns = 0, dedup_ns = 0;
  uint64_t extend_ns = 0, pair_ns = 0;
  for (const auto& w : pass->workers) {
    for (int64_t i = 0; i < hist_size; ++i) pass->histogram[i] += w->histogram[i];
    pass->unaligned += w->unaligned;
    wait_ns += w->wait_ns;
    arena_bytes += w->arena.capacity();
    distinct += w->table.size();
    project_ns += w->project_ns;
    dedup_ns += w->dedup_ns;
    extend_ns += w->finder.extend_ns;
    pair_ns += w->finder.pair_ns;
  }
  stats[0] = static_cast<double>(error);
  stats[1] = static_cast<double>(blocks);
  stats[2] = static_cast<double>(bytes);
  stats[3] = static_cast<double>(arena_bytes);
  stats[4] = read_ns * 1e-9;
  stats[5] = wait_ns * 1e-9 / n_threads;
  if (prof_on()) {
    std::fprintf(stderr,
                 "  [native-prof] flat fragment pass: read %.3fs, prescan %.3fs, wait "
                 "%.3fs a worker; thread-CPU projection %.3fs (extend %.3fs, pair %.3fs), "
                 "dedup %.3fs; %llu blocks, %llu worker-distinct lists, %llu arena bytes\n",
                 read_ns * 1e-9, prescan_ns * 1e-9, wait_ns * 1e-9 / n_threads,
                 project_ns * 1e-9, extend_ns * 1e-9, pair_ns * 1e-9, dedup_ns * 1e-9,
                 static_cast<unsigned long long>(blocks),
                 static_cast<unsigned long long>(distinct),
                 static_cast<unsigned long long>(arena_bytes));
  }
  return pass;
}

void rpvg_flat_free(void* handle) { delete static_cast<flat::Pass*>(handle); }

// The pass's distinct lists in rpvg_indexer_dump_located's layout, on
// `n_threads` threads.  nullptr (and *out_len -1) when the buffer cannot
// be allocated.
uint8_t* rpvg_flat_dump(void* handle, void* index_handle, int64_t* out_len,
                        int32_t n_threads) {
  using namespace flat;
  auto* pass = static_cast<Pass*>(handle);
  const Index& idx = *static_cast<Index*>(index_handle);
  const bool prof = prof_on();
  const uint64_t tp0 = prof ? prof_wall() : 0;
  const int32_t threads = std::max(1, std::min<int32_t>(n_threads, 16));

  auto run = [threads](const auto& body) {
    if (threads == 1) {
      body(0);
      return;
    }
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(body, t);
    for (auto& th : pool) th.join();
  };

  // Merge: shard s takes the keys whose hash lands on s, so one list is
  // merged in one shard whichever workers counted it.
  size_t total = 0;
  for (const auto& w : pass->workers) total += w->table.size();
  std::vector<std::vector<Slot>> shard_entries(threads);
  run([&](int32_t s) {
    Table merged(2 * (total / threads + 16), false);
    for (const auto& w : pass->workers) {
      for (const Slot& slot : w->table.slots()) {
        if (slot.count == 0 || static_cast<int32_t>((slot.hash >> 40) % threads) != s) continue;
        merged.add(w->table.key_of(slot), slot.len, slot.hash, slot.count, slot.ord);
      }
    }
    auto& list = shard_entries[s];
    list.reserve(merged.size());
    for (const Slot& slot : merged.slots()) {
      if (slot.count) list.push_back(slot);
    }
  });
  std::vector<Slot> entries;
  {
    size_t n_entries = 0;
    for (const auto& list : shard_entries) n_entries += list.size();
    entries.reserve(n_entries);
    for (auto& list : shard_entries) {
      entries.insert(entries.end(), list.begin(), list.end());
      std::vector<Slot>().swap(list);
    }
  }
  // Canonical order: the first fragment of each list, in file order.
  std::sort(entries.begin(), entries.end(),
            [](const Slot& a, const Slot& b) { return a.ord < b.ord; });
  const int64_t n = static_cast<int64_t>(entries.size());
  const uint64_t tp1 = prof ? prof_wall() : 0;

  // Sequence of every concat position (locate_path_ids's upper_bound).
  const int64_t concat_len = static_cast<int64_t>(idx.concat.size());
  std::vector<int32_t> seq_of(concat_len);
  {
    const int64_t n_seqs = static_cast<int64_t>(idx.seq_starts.size());
    int64_t first = n_seqs ? std::min(idx.seq_starts[0], concat_len) : concat_len;
    std::fill(seq_of.begin(), seq_of.begin() + std::max<int64_t>(0, first), -1);
    for (int64_t s = 0; s < n_seqs; ++s) {
      const int64_t begin = std::max<int64_t>(0, std::min(idx.seq_starts[s], concat_len));
      const int64_t end = s + 1 < n_seqs
                              ? std::max<int64_t>(0, std::min(idx.seq_starts[s + 1], concat_len))
                              : concat_len;
      for (int64_t p = begin; p < end; ++p) seq_of[p] = static_cast<int32_t>(s);
    }
  }
  const uint64_t tp2 = prof ? prof_wall() : 0;

  std::vector<int64_t> anchors(n);
  std::vector<int32_t> n_ids(n);
  std::vector<std::vector<int64_t>> ids_of_range(threads);
  const bool bidirectional = idx.bidirectional;
  run([&](int32_t t) {
    const int64_t begin = n * t / threads;
    const int64_t end = n * (t + 1) / threads;
    std::vector<int64_t>& range_ids = ids_of_range[t];
    std::vector<int64_t> ids;
    for (int64_t e = begin; e < end; ++e) {
      const uint8_t* cur = reinterpret_cast<const uint8_t*>(entries[e].ref);
      int32_t n_paths;
      std::memcpy(&n_paths, cur, 4);
      cur += 4;
      int64_t anchor = -1;
      ids.clear();
      for (int32_t i = 0; i < n_paths; ++i) {
        int32_t n_pos;
        std::memcpy(&n_pos, cur + 8, 4);
        const uint8_t* positions = cur + 12;
        // locate_path_ids: a new sequence starts a new id.
        int64_t prev = -1;
        bool first = true;
        for (int32_t k = 0; k < n_pos; ++k) {
          int64_t position;
          std::memcpy(&position, positions + 8 * static_cast<size_t>(k), 8);
          const int64_t seq = seq_of[position];
          if (seq == prev) continue;
          prev = seq;
          const int64_t id = bidirectional ? seq / 2 : seq;
          if (first && anchor < 0) anchor = id;
          first = false;
          ids.push_back(id);
        }
        cur += 12 + 8 * static_cast<int64_t>(n_pos) + 17;
      }
      std::sort(ids.begin(), ids.end());
      ids.erase(std::unique(ids.begin(), ids.end()), ids.end());
      anchors[e] = anchor;
      n_ids[e] = static_cast<int32_t>(ids.size());
      range_ids.insert(range_ids.end(), ids.begin(), ids.end());
    }
  });
  const uint64_t tp3 = prof ? prof_wall() : 0;

  size_t ids_total = 0;
  for (const auto& range_ids : ids_of_range) ids_total += range_ids.size();
  std::vector<int64_t> blob_offsets(n + 1);
  blob_offsets[0] = 0;
  for (int64_t e = 0; e < n; ++e) {
    blob_offsets[e + 1] = blob_offsets[e] + 8 + static_cast<int64_t>(entries[e].len);
  }
  const size_t raw_total = static_cast<size_t>(blob_offsets[n]);
  const size_t hist_size = pass->histogram.size();
  const size_t total_bytes =
      8 + static_cast<size_t>(n) * 28 + 8 + ids_total * 8 + raw_total + 8 + hist_size * 8;
  auto* out = static_cast<uint8_t*>(std::malloc(total_bytes));
  if (out == nullptr) {
    *out_len = -1;
    return nullptr;
  }
  uint8_t* cur = out;
  auto put = [&cur](const void* src, size_t bytes) {
    std::memcpy(cur, src, bytes);
    cur += bytes;
  };
  const uint64_t n_u = static_cast<uint64_t>(n);
  put(&n_u, 8);
  uint8_t* counts_at = cur;
  cur += 8 * n;
  put(anchors.data(), 8 * n);
  put(n_ids.data(), 4 * n);
  const uint64_t ids_u = ids_total;
  put(&ids_u, 8);
  for (const auto& range_ids : ids_of_range) put(range_ids.data(), 8 * range_ids.size());
  uint8_t* lens_at = cur;
  cur += 8 * n;
  uint8_t* blob_base = cur;
  run([&](int32_t t) {
    const int64_t begin = n * t / threads;
    const int64_t end = n * (t + 1) / threads;
    for (int64_t e = begin; e < end; ++e) {
      const uint64_t count = entries[e].count;
      const int64_t raw_len = 8 + static_cast<int64_t>(entries[e].len);
      std::memcpy(counts_at + 8 * e, &count, 8);
      std::memcpy(lens_at + 8 * e, &raw_len, 8);
      uint8_t* dst = blob_base + blob_offsets[e];
      std::memcpy(dst, &count, 8);
      std::memcpy(dst + 8, reinterpret_cast<const uint8_t*>(entries[e].ref), entries[e].len);
    }
  });
  cur = blob_base + raw_total;
  put(&pass->unaligned, 8);
  put(pass->histogram.data(), 8 * hist_size);
  *out_len = static_cast<int64_t>(total_bytes);
  if (prof) {
    std::fprintf(stderr,
                 "  [native-prof] flat dump wall: merge %.3fs table %.3fs locate %.3fs "
                 "serialize %.3fs (%lld entries, %zu bytes)\n",
                 (tp1 - tp0) * 1e-9, (tp2 - tp1) * 1e-9, (tp3 - tp2) * 1e-9,
                 (prof_wall() - tp3) * 1e-9, static_cast<long long>(n), total_bytes);
  }
  return out;
}

}  // extern "C"
