// The port's host library: the .hgr tokenizer, the clique expansion and
// the Benes router.
//
// A copy of three parts of native/eigkl_native.cpp, which the JAX package
// loads as native/libeigkl.so; the port never loads that library.  It
// keeps the same entry points: ekl_read_hgr (.hgr -> pins and net
// offsets), ekl_clique_expand (hypergraph -> deduplicated symmetric CSR,
// equal to the NumPy expansion in graph/expand.py bit for bit; see the
// merge below), and ekl_benes_route (switch bits of a Benes network for
// the v3 SpMV plan, ops/spmv_v3.py), equal to the JAX package's word for
// word.  The chunk planners of the v1 and v2 TPU SpMV layouts are left
// out: the port has no such layouts.
//
// Built with the host C++ compiler (-O3 -fPIC, no CUDA) at first use into
// eig_kl_tpu_torch/_build/ (ops/_build.py) and bound with ctypes
// (io/native_io.py).  It runs on one thread: the JAX package's copy spreads
// the expansion over OpenMP threads, but not every host compiler ships
// OpenMP's runtime (libgomp), and the output is the same either way.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

typedef struct {
  int64_t num_nets;
  int64_t num_nodes;
  int64_t num_pins;
  int32_t* pins;         // 0-based node ids, concatenated per net
  int64_t* net_offsets;  // num_nets + 1
  int32_t status;        // 0 ok, nonzero = error code
} EklHgr;

typedef struct {
  int64_t n;
  int64_t nnz;
  int64_t* indptr;   // n + 1
  int32_t* indices;  // nnz, sorted within row
  double* data;      // nnz
  int32_t status;
} EklCsr;

// ---------------------------------------------------------------------
// .hgr loader
// ---------------------------------------------------------------------

EklHgr* ekl_read_hgr(const char* path) {
  EklHgr* out = new EklHgr();
  std::memset(out, 0, sizeof(EklHgr));

  FILE* f = std::fopen(path, "rb");
  if (!f) {
    out->status = 1;
    return out;
  }
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  std::vector<char> buf(static_cast<size_t>(size) + 1);
  size_t got = std::fread(buf.data(), 1, static_cast<size_t>(size), f);
  std::fclose(f);
  buf[got] = '\0';

  const char* p = buf.data();
  const char* end = p + got;

  auto skip_ws_inline = [&](const char*& q) {
    while (q < end && (*q == ' ' || *q == '\t' || *q == '\r')) q++;
  };
  auto parse_int = [&](const char*& q, int64_t& val) -> bool {
    skip_ws_inline(q);
    if (q >= end || *q < '0' || *q > '9') return false;
    int64_t v = 0;
    while (q < end && *q >= '0' && *q <= '9') v = v * 10 + (*q++ - '0');
    val = v;
    return true;
  };

  int64_t num_nets = 0, num_nodes = 0;
  if (!parse_int(p, num_nets) || !parse_int(p, num_nodes)) {
    out->status = 2;
    return out;
  }
  // advance to end of header line
  while (p < end && *p != '\n') p++;
  if (p < end) p++;

  std::vector<int32_t> pins;
  pins.reserve(static_cast<size_t>(num_nets) * 3);
  std::vector<int64_t> offsets(static_cast<size_t>(num_nets) + 1, 0);

  for (int64_t i = 0; i < num_nets; i++) {
    int64_t v;
    while (true) {
      skip_ws_inline(p);
      if (p >= end || *p == '\n') break;
      if (!parse_int(p, v)) {
        out->status = 3;
        return out;
      }
      if (v < 1 || v > num_nodes) {
        out->status = 4;
        return out;
      }
      pins.push_back(static_cast<int32_t>(v - 1));  // 0-based (cEIG.cpp:99)
    }
    offsets[i + 1] = static_cast<int64_t>(pins.size());
    if (p < end) p++;  // consume newline
  }

  out->num_nets = num_nets;
  out->num_nodes = num_nodes;
  out->num_pins = static_cast<int64_t>(pins.size());
  out->pins = new int32_t[pins.size() ? pins.size() : 1];
  std::memcpy(out->pins, pins.data(), pins.size() * sizeof(int32_t));
  out->net_offsets = new int64_t[num_nets + 1];
  std::memcpy(out->net_offsets, offsets.data(),
              (num_nets + 1) * sizeof(int64_t));
  return out;
}

void ekl_free_hgr(EklHgr* h) {
  if (!h) return;
  delete[] h->pins;
  delete[] h->net_offsets;
  delete h;
}

// ---------------------------------------------------------------------
// Clique expansion -> deduplicated symmetric CSR
// ---------------------------------------------------------------------

// mode 0: w = 2/k (cEIG.cpp:110); mode 1: w = 1/(k-1) (cKL.cpp:117).
EklCsr* ekl_clique_expand(int64_t num_nodes, int64_t num_nets,
                          const int32_t* pins, const int64_t* net_offsets,
                          int32_t mode) {
  EklCsr* out = new EklCsr();
  std::memset(out, 0, sizeof(EklCsr));
  out->n = num_nodes;

  // Phase 1: raw slot count per node (each member of a k-pin net emits
  // k-1 directed entries; nets with k < 2 emit nothing, gKL.cu:622).
  std::vector<int64_t> raw_count(static_cast<size_t>(num_nodes) + 1, 0);
  for (int64_t i = 0; i < num_nets; i++) {
    int64_t k = net_offsets[i + 1] - net_offsets[i];
    if (k < 2) continue;
    for (int64_t j = net_offsets[i]; j < net_offsets[i + 1]; j++)
      raw_count[static_cast<size_t>(pins[j]) + 1] += k - 1;
  }
  for (int64_t i = 0; i < num_nodes; i++) raw_count[i + 1] += raw_count[i];
  const int64_t raw_nnz = raw_count[num_nodes];

  std::vector<int32_t> raw_idx(static_cast<size_t>(raw_nnz));
  std::vector<double> raw_w(static_cast<size_t>(raw_nnz));
  std::vector<int64_t> cursor(raw_count.begin(), raw_count.end() - 1);

  // Phase 2: emit directed pairs into each node's slots, in net order.
  for (int64_t i = 0; i < num_nets; i++) {
    int64_t k = net_offsets[i + 1] - net_offsets[i];
    if (k < 2) continue;
    double w = (mode == 0) ? 2.0 / static_cast<double>(k)
                           : 1.0 / static_cast<double>(k - 1);
    for (int64_t a = net_offsets[i]; a < net_offsets[i + 1]; a++) {
      for (int64_t b = a + 1; b < net_offsets[i + 1]; b++) {
        int32_t u = pins[a], v = pins[b];
        if (u == v) {
          // Repeated pin within one net: drop (matches the Python
          // path; well-formed circuits never hit this).  Both slots
          // were counted, so park zero-weight self entries that the
          // merge phase drops.
        }
        int64_t su = cursor[u]++;
        int64_t sv = cursor[v]++;
        raw_idx[su] = v;
        raw_w[su] = (u == v) ? 0.0 : w;
        raw_idx[sv] = u;
        raw_w[sv] = (u == v) ? 0.0 : w;
      }
    }
  }

  // Phase 3: per-row sort + duplicate merge.
  std::vector<int64_t> row_nnz(static_cast<size_t>(num_nodes), 0);
  {
    std::vector<std::pair<int32_t, double>> scratch;
    for (int64_t r = 0; r < num_nodes; r++) {
      int64_t lo = raw_count[r], hi = raw_count[r + 1];
      scratch.clear();
      for (int64_t j = lo; j < hi; j++) {
        if (raw_idx[j] == r) continue;  // drop self-loops
        scratch.emplace_back(raw_idx[j], raw_w[j]);
      }
      // Weight as tie-breaker, largest first: sorting on (idx, -w) adds
      // the weights of a pair in the order of the NumPy expansion
      // (graph/expand.py adds them by net size, smallest first, and both
      // weightings fall with net size), so the two agree bit for bit.  The
      // JAX package's copy sorts on (idx, w) and can differ in the last bit
      // when one pair has three or more weights.
      std::sort(scratch.begin(), scratch.end(),
                [](const std::pair<int32_t, double>& a,
                   const std::pair<int32_t, double>& b) {
                  return a.first < b.first ||
                         (a.first == b.first && a.second > b.second);
                });
      int64_t m = 0;
      for (size_t j = 0; j < scratch.size(); j++) {
        if (m > 0 && scratch[m - 1].first == scratch[j].first) {
          scratch[m - 1].second += scratch[j].second;
        } else {
          scratch[m++] = scratch[j];
        }
      }
      // Compact merged row back into the raw arrays (prefix of the row).
      for (int64_t j = 0; j < m; j++) {
        raw_idx[lo + j] = scratch[j].first;
        raw_w[lo + j] = scratch[j].second;
      }
      row_nnz[r] = m;
    }
  }

  out->indptr = new int64_t[num_nodes + 1];
  out->indptr[0] = 0;
  for (int64_t r = 0; r < num_nodes; r++)
    out->indptr[r + 1] = out->indptr[r] + row_nnz[r];
  out->nnz = out->indptr[num_nodes];
  out->indices = new int32_t[out->nnz ? out->nnz : 1];
  out->data = new double[out->nnz ? out->nnz : 1];
  for (int64_t r = 0; r < num_nodes; r++) {
    int64_t src = raw_count[r], dst = out->indptr[r];
    std::memcpy(out->indices + dst, raw_idx.data() + src,
                row_nnz[r] * sizeof(int32_t));
    std::memcpy(out->data + dst, raw_w.data() + src,
                row_nnz[r] * sizeof(double));
  }
  return out;
}

void ekl_free_csr(EklCsr* c) {
  if (!c) return;
  delete[] c->indptr;
  delete[] c->indices;
  delete[] c->data;
  delete c;
}

}  // extern "C"

extern "C" {

// ---------------------------------------------------------------------
// Benes network routing.
//
// A Benes network on N = 2^m elements realizes ANY permutation with
// 2m-1 stages of 2:2 switches; stage s has distance d_s (N/2, N/4,
// ..., 2, 1, 2, ..., N/2) and swaps positions p and p^d_s where the
// stage's per-position bit is set (bits are set on BOTH partners of a
// swapped pair, so a kernel only tests its own position).  The SpMV
// v3 pipeline uses it to move gathered edge values from column-sorted
// to row-sorted order entirely with vector shifts + selects -- the
// one data movement a sparse matvec cannot window away.
//
// ekl_benes_route computes switch bits for the SCATTER semantics
//   out[dest[j]] = in[j]
// by the classic recursive 2-coloring of constraint cycles (iterative
// over levels).  masks: (2m-1) rows of N/32 little-endian uint32
// words, caller-allocated and zeroed.
// ---------------------------------------------------------------------

static inline void set_bit(uint32_t* bits, int64_t p) {
  bits[p >> 5] |= 1u << (p & 31);
}

// Route one sub-block of size M = 2*half starting at absolute
// position `base`.  dest: block-relative destinations (size M),
// overwritten garbage; dest_out: the two half-size sub-permutations
// (top at [0,half), bottom at [half,M)).
static void benes_block(int64_t base, int64_t half, const int32_t* dest,
                        int32_t* dest_out, int32_t* color, int32_t* inv,
                        uint32_t* first_bits, uint32_t* last_bits) {
  const int64_t M = 2 * half;
  for (int64_t j = 0; j < M; ++j) inv[dest[j]] = (int32_t)j;
  std::fill(color, color + M, -1);
  for (int64_t start = 0; start < M; ++start) {
    if (color[start] != -1) continue;
    int64_t j = start;
    while (color[j] == -1) {
      color[j] = 0;
      int64_t jp = j ^ half;          // input partner -> other subnet
      color[jp] = 1;
      // jp's output-switch mate must route through subnet 0.
      j = inv[dest[jp] ^ half];
    }
  }
  for (int64_t j = 0; j < M; ++j) {
    int32_t c = color[j];
    int64_t d = dest[j];
    // Sub-permutation: enters subnet c at (j % half), must exit at
    // (d % half).
    dest_out[(int64_t)c * half + (j % half)] = (int32_t)(d % half);
    if (j < half && c == 1) {
      // First stage: slot j routed to the bottom subnet -> swap.
      set_bit(first_bits, base + j);
      set_bit(first_bits, base + j + half);
    }
    // Last stage: top subnet exits to output (d%half) when unswapped;
    // swap needed iff the element's subnet disagrees with its output
    // half.
    if ((d >= half) == (c == 0)) {
      set_bit(last_bits, base + (d % half));
      // both partners (idempotent under the constraint pairing)
      set_bit(last_bits, base + (d % half) + half);
    }
  }
}

int32_t ekl_benes_route(int64_t N, const int32_t* dest, uint32_t* masks) {
  int64_t m = 0;
  while ((1LL << m) < N) ++m;
  if ((1LL << m) != N || N < 2) return 1;
  const int64_t stages = 2 * m - 1;
  const int64_t words = N / 32;
  std::vector<int32_t> cur(dest, dest + N), nxt(N);
  std::vector<int32_t> color(N), inv(N);
  for (int64_t lev = 0; lev < m - 1; ++lev) {
    const int64_t M = N >> lev;
    const int64_t half = M / 2;
    uint32_t* fb = masks + lev * words;
    uint32_t* lb = masks + (stages - 1 - lev) * words;
    for (int64_t b = 0; b < (1LL << lev); ++b) {
      benes_block(b * M, half, cur.data() + b * M, nxt.data() + b * M,
                  color.data(), inv.data(), fb, lb);
    }
    std::swap(cur, nxt);
  }
  // Middle stage: blocks of size 2; swap iff the pair is crossed.
  uint32_t* mb = masks + (m - 1) * words;
  for (int64_t p = 0; p < N; p += 2) {
    if (cur[p] == 1) {
      set_bit(mb, p);
      set_bit(mb, p + 1);
    }
  }
  return 0;
}

}  // extern "C"
