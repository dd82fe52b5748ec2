// Single-threaded native HNSW engine — the host-side reference baseline.
//
// The upstream reference (lehy/ocaml-hnsw) is a pure-OCaml, single-threaded
// HNSW (SURVEY.md §0; its mount was empty, so the behavioral spec is the HNSW
// paper, Malkov & Yashunin arXiv:1603.09320, Algorithms 1–5 — implemented
// here from the paper, matching the Python oracle in oracle/hnsw.py).
//
// Roles in this framework (it is NOT on the accelerator serving path):
//  1. the measurable stand-in for the reference's single-threaded build/query
//     throughput — the "≥10× the single-threaded reference" build target
//     (BASELINE.json) is scored against this engine on the host CPU;
//  2. a fast behavioral oracle for large parity tests (the NumPy oracle is
//     exact but slow beyond a few thousand points).
//
// Exposed as a C ABI consumed via ctypes (ocaml_hnsw_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <queue>
#include <random>
#include <utility>
#include <vector>

namespace {

using Pair = std::pair<float, int32_t>;  // (distance, node id)

struct Hnsw {
  int dim = 0;
  int metric = 0;  // 0 = l2 (squared), 1 = ip/cosine (1 - dot)
  int M = 16;
  int M_max0 = 32;
  int ef_construction = 200;
  double mL = 0.0;
  std::mt19937_64 rng;
  std::uniform_real_distribution<double> unif{0.0, 1.0};

  std::vector<float> vectors;           // n * dim
  std::vector<int32_t> levels;
  std::vector<std::vector<std::vector<int32_t>>> adj;  // [node][level] -> ids
  int32_t entry = -1;
  int32_t max_level = -1;

  // per-search visited marks, epoch-tagged so no clearing pass is needed
  std::vector<uint32_t> visit_tag;
  uint32_t visit_epoch = 0;

  const float* row(int32_t i) const { return vectors.data() + size_t(i) * dim; }

  float dist(const float* a, const float* b) const {
    float acc = 0.f;
    if (metric == 0) {
      for (int i = 0; i < dim; ++i) {
        const float d = a[i] - b[i];
        acc += d * d;
      }
      return acc;
    }
    for (int i = 0; i < dim; ++i) acc += a[i] * b[i];
    return 1.0f - acc;
  }

  // Alg 2 SEARCH-LAYER: beam of width ef inside layer lc.
  // Returns results sorted ascending by distance.
  std::vector<Pair> search_layer(const float* q, const std::vector<int32_t>& eps,
                                 size_t ef, int lc) {
    ++visit_epoch;
    std::priority_queue<Pair, std::vector<Pair>, std::greater<Pair>> cand;
    std::priority_queue<Pair> result;  // max-heap: furthest first
    for (int32_t e : eps) {
      visit_tag[e] = visit_epoch;
      const float d = dist(q, row(e));
      cand.emplace(d, e);
      result.emplace(d, e);
    }
    while (!cand.empty()) {
      const auto [dc, c] = cand.top();
      if (dc > result.top().first) break;  // beam termination
      cand.pop();
      for (int32_t e : adj[c][lc]) {
        if (visit_tag[e] == visit_epoch) continue;
        visit_tag[e] = visit_epoch;
        const float de = dist(q, row(e));
        if (de < result.top().first || result.size() < ef) {
          cand.emplace(de, e);
          result.emplace(de, e);
          if (result.size() > ef) result.pop();
        }
      }
    }
    std::vector<Pair> out(result.size());
    for (size_t i = result.size(); i-- > 0;) {
      out[i] = result.top();
      result.pop();
    }
    return out;
  }

  // Alg 4 SELECT-NEIGHBORS-HEURISTIC (extendCandidates/keepPruned off,
  // matching the framework defaults): admit e iff strictly closer to q than
  // to every already-admitted candidate.
  std::vector<Pair> select_heuristic(const float* /*q*/,
                                     std::vector<Pair> cands, size_t m) {
    std::sort(cands.begin(), cands.end());
    std::vector<Pair> sel;
    sel.reserve(m);
    for (const auto& [de, e] : cands) {
      if (sel.size() >= m) break;
      bool ok = true;
      for (const auto& [dr, r] : sel) {
        if (dist(row(e), row(r)) <= de) {
          ok = false;
          break;
        }
      }
      if (ok) sel.emplace_back(de, e);
    }
    return sel;
  }

  // Alg 1 INSERT.
  void add_one(const float* vec) {
    const int32_t idx = int32_t(levels.size());
    vectors.insert(vectors.end(), vec, vec + dim);
    if (metric == 1) {  // cosine rows are pre-normalized by the wrapper
    }
    const int32_t lvl = int32_t(-std::log(1.0 - unif(rng)) * mL);
    levels.push_back(lvl);
    adj.emplace_back(lvl + 1);
    visit_tag.push_back(0);
    if (entry < 0) {
      entry = idx;
      max_level = lvl;
      return;
    }
    std::vector<int32_t> ep{entry};
    const float* q = row(idx);
    for (int lc = max_level; lc > lvl; --lc)
      ep = {search_layer(q, ep, 1, lc)[0].second};
    for (int lc = std::min(max_level, lvl); lc >= 0; --lc) {
      auto w = search_layer(q, ep, ef_construction, lc);
      auto neighbors = select_heuristic(q, w, M);
      auto& mine = adj[idx][lc];
      mine.reserve(neighbors.size());
      const size_t m_max = (lc == 0) ? size_t(M_max0) : size_t(M);
      for (const auto& [de, e] : neighbors) {
        mine.push_back(e);
        auto& theirs = adj[e][lc];
        theirs.push_back(idx);
        if (theirs.size() > m_max) {  // Alg 1 shrink
          std::vector<Pair> cands;
          cands.reserve(theirs.size());
          for (int32_t x : theirs) cands.emplace_back(dist(row(e), row(x)), x);
          auto pruned = select_heuristic(row(e), std::move(cands), m_max);
          theirs.clear();
          for (const auto& [dx, x] : pruned) theirs.push_back(x);
        }
      }
      ep.clear();
      for (const auto& [dw, e] : w) ep.push_back(e);
    }
    if (lvl > max_level) {
      entry = idx;
      max_level = lvl;
    }
  }

  // Alg 5 K-NN-SEARCH.
  void query_one(const float* q, int k, size_t ef, int64_t* out_ids,
                 float* out_d) {
    std::vector<int32_t> ep{entry};
    for (int lc = max_level; lc >= 1; --lc)
      ep = {search_layer(q, ep, 1, lc)[0].second};
    auto w = search_layer(q, ep, std::max(ef, size_t(k)), 0);
    const int found = int(std::min(w.size(), size_t(k)));
    for (int i = 0; i < found; ++i) {
      out_ids[i] = w[i].second;
      out_d[i] = w[i].first;
    }
    for (int i = found; i < k; ++i) {
      out_ids[i] = -1;
      out_d[i] = std::numeric_limits<float>::infinity();
    }
  }
};

}  // namespace

extern "C" {

void* hnsw_ref_create(int dim, int metric, int m, int ef_construction,
                      uint64_t seed) {
  auto* h = new Hnsw();
  h->dim = dim;
  h->metric = metric;
  h->M = m;
  h->M_max0 = 2 * m;
  h->ef_construction = ef_construction;
  h->mL = 1.0 / std::log(double(m));
  h->rng.seed(seed);
  return h;
}

void hnsw_ref_add(void* handle, int64_t n, const float* data) {
  auto* h = static_cast<Hnsw*>(handle);
  for (int64_t i = 0; i < n; ++i) h->add_one(data + i * h->dim);
}

void hnsw_ref_query(void* handle, int64_t nq, const float* queries, int k,
                    int ef, int64_t* out_ids, float* out_d) {
  auto* h = static_cast<Hnsw*>(handle);
  for (int64_t i = 0; i < nq; ++i)
    h->query_one(queries + i * h->dim, k, size_t(ef), out_ids + i * k,
                 out_d + i * k);
}

int64_t hnsw_ref_count(void* handle) {
  return static_cast<Hnsw*>(handle)->levels.size();
}

void hnsw_ref_free(void* handle) { delete static_cast<Hnsw*>(handle); }

}  // extern "C"
