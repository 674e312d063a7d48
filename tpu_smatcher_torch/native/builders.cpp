// Native host code of tpu_smatcher_torch: table builders, the threaded CPU
// ground-truth count and match enumerator, and the FASTA encoder.
//
// The counterpart of the reference's C preprocessing layer (the trie /
// factor-oracle construction in ac/ac.c, sh/sh.c, sbom/sbom.c): the scan
// kernels run on the GPU, but automaton construction is pointer-chasing work
// that belongs on the host in native code.  Builders write directly into
// numpy-allocated flat arrays handed across a plain C ABI (ctypes; built and
// bound by tpu_smatcher_torch/native/__init__.py).
//
// Conventions (shared with the numpy builders in tpu_smatcher_torch/automata/):
//   - transition: (S_max, sigma) int32, -1 = missing (AC root row defaults 0)
//   - supply:     (S_max,) int32 failure/supply links
//   - final:      (S_max,) uint8
//   - delta:      (S_max, sigma+1) int32 completed DFA, pad column -> 0
//   - S_max = m * p + 1 (the reference's bound, main.c:409-411)
//
// All functions return the number of states actually used, or -1 on error.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int32_t &trans_at(int32_t *t, int64_t sigma, int32_t s, int32_t c) {
  return t[(int64_t)s * sigma + c];
}

}  // namespace

extern "C" {

// Aho-Corasick: forward trie + BFS failure links + completed DFA.
int64_t tpu_build_ac(const uint8_t *pats, int64_t p, int64_t m, int64_t sigma,
                     int32_t *transition, int32_t *supply, uint8_t *final_,
                     int32_t *delta, int32_t *depth) {
  const int64_t s_max = m * p + 1;
  std::fill(transition, transition + s_max * sigma, -1);
  std::fill(supply, supply + s_max, 0);
  std::fill(final_, final_ + s_max, 0);
  std::fill(depth, depth + s_max, 0);
  for (int64_t c = 0; c < sigma; ++c) trans_at(transition, sigma, 0, c) = 0;

  // trie insertion: the flat transition array IS the trie (root row uses 0
  // as "missing", deeper rows use -1)
  int32_t n_states = 1;
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    int32_t s = 0;
    for (int64_t i = 0; i < m; ++i) {
      const uint8_t c = pat[i];
      if (c >= sigma) return -1;
      int32_t nxt = trans_at(transition, sigma, s, c);
      const bool missing = (s == 0) ? (nxt == 0) : (nxt < 0);
      if (missing) {
        nxt = n_states++;
        trans_at(transition, sigma, s, c) = nxt;
        depth[nxt] = depth[s] + 1;
      }
      s = nxt;
    }
    final_[s] = 1;
  }

  // BFS over depth levels; compute supply + completed delta rows.
  const int64_t sig_p = sigma + 1;
  // delta row 0: root transitions, missing -> 0 already encoded
  for (int64_t c = 0; c < sigma; ++c)
    delta[c] = trans_at(transition, sigma, 0, c);
  delta[sigma] = 0;

  std::vector<int32_t> queue;
  queue.reserve(n_states);
  for (int64_t c = 0; c < sigma; ++c) {
    int32_t t = trans_at(transition, sigma, 0, c);
    if (t > 0) {
      supply[t] = 0;
      queue.push_back(t);
    }
  }
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    const int32_t s = queue[qi];
    const int32_t f = supply[s];
    int32_t *drow = delta + (int64_t)s * sig_p;
    const int32_t *frow = delta + (int64_t)f * sig_p;
    for (int64_t c = 0; c < sigma; ++c) {
      const int32_t t = trans_at(transition, sigma, s, c);
      if (t >= 0 && !(s == 0 && t == 0)) {
        drow[c] = t;
        supply[t] = frow[c];
        queue.push_back(t);
      } else {
        drow[c] = frow[c];
      }
    }
    drow[sigma] = 0;
  }
  return n_states;
}

// Set Horspool: trie over reversed patterns (-1 missing everywhere) + bmBc.
int64_t tpu_build_sh(const uint8_t *pats, int64_t p, int64_t m, int64_t sigma,
                     int32_t *transition, uint8_t *final_, int32_t *bmBc) {
  const int64_t s_max = m * p + 1;
  std::fill(transition, transition + s_max * sigma, -1);
  std::fill(final_, final_ + s_max, 0);
  int32_t n_states = 1;
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    int32_t s = 0;
    for (int64_t i = m - 1; i >= 0; --i) {
      const uint8_t c = pat[i];
      if (c >= sigma) return -1;
      int32_t nxt = trans_at(transition, sigma, s, c);
      if (nxt < 0) {
        nxt = n_states++;
        trans_at(transition, sigma, s, c) = nxt;
      }
      s = nxt;
    }
    final_[s] = 1;
  }
  for (int64_t c = 0; c < sigma; ++c) bmBc[c] = (int32_t)m;
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    for (int64_t i = 0; i < m - 1; ++i) {
      const int32_t shift = (int32_t)(m - 1 - i);
      if (shift < bmBc[pat[i]]) bmBc[pat[i]] = shift;
    }
  }
  return n_states;
}

// SBOM factor oracle of reversed patterns (external transitions patched along
// the supply chain during insertion, mirroring sbom/sbom.c:99-116 semantics).
// Terminal pattern ids returned as a linked list: f_head[s] = first entry or
// -1; f_entry_pid/f_entry_next indexed by insertion order (p entries max).
int64_t tpu_build_sbom(const uint8_t *pats, int64_t p, int64_t m, int64_t sigma,
                       int32_t *transition, int32_t *f_head,
                       int32_t *f_entry_pid, int32_t *f_entry_next) {
  const int64_t s_max = m * p + 1;
  std::fill(transition, transition + s_max * sigma, -1);
  std::fill(f_head, f_head + s_max, -1);
  std::vector<int32_t> supply(s_max, -2);  // -2 = unset; -1 = none (root)
  supply[0] = -1;
  int32_t n_states = 1;
  int32_t n_entries = 0;
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    int32_t s = 0;
    int64_t i = m - 1;
    bool done = false;
    while (!done) {  // follow existing transitions
      const uint8_t c = pat[i];
      if (c >= sigma) return -1;
      const int32_t nxt = trans_at(transition, sigma, s, c);
      if (nxt < 0) break;
      s = nxt;
      if (i <= 0) done = true;
      --i;
    }
    if (!done) {
      for (; i >= 0; --i) {
        const uint8_t c = pat[i];
        if (c >= sigma) return -1;
        const int32_t nw = n_states++;
        trans_at(transition, sigma, s, c) = nw;
        int32_t k = supply[s];
        while (k >= 0 && trans_at(transition, sigma, k, c) < 0) {
          trans_at(transition, sigma, k, c) = nw;   // external transition
          k = supply[k];
        }
        supply[nw] = (k >= 0) ? trans_at(transition, sigma, k, c) : 0;
        s = nw;
      }
    }
    // append pattern id j to F(s): entries are prepended, so each state's
    // list is linked newest first; the caller reverses it to insertion order
    f_entry_pid[n_entries] = (int32_t)j;
    f_entry_next[n_entries] = f_head[s];
    f_head[s] = n_entries;
    ++n_entries;
  }
  return n_states;
}

// CPU reference scan — the native analogue of the reference's live CPU path
// (multiwm2 -> search_wu2, wu/wu.c:151-209): patterns bucketed by their last
// two bytes, every window end checked against its bucket with memcmp, <= 1
// count per window.  Counts equal datagen.count_matches (windows with >= 1
// exact occurrence); used for full-scale ground-truth verification where the
// numpy oracle would need gigabytes of materialized windows.
int64_t tpu_count_cpu(const uint8_t* text, int64_t n, const uint8_t* patterns,
                      int64_t p, int64_t m) {
  if (n < m || p == 0 || m <= 0) return 0;
  int64_t count = 0;
  if (m == 1) {
    bool present[256] = {false};
    for (int64_t j = 0; j < p; ++j) present[patterns[j]] = true;
    for (int64_t i = 0; i < n; ++i) count += present[text[i]];
    return count;
  }
  // bucket by a multiplicative fold of the last min(m,16) bytes: small
  // alphabets need a long tail to spread (sigma=2 has only 256 distinct
  // 8-byte tails for 65536 buckets and chains explode); memcmp keeps the
  // count exact
  const int64_t kb = m < 16 ? m : 16;
  auto hash_tail = [kb](const uint8_t* end_m1) {
    uint32_t h = 0;
    for (int64_t k = 0; k < kb; ++k) h = h * 131u + end_m1[-k];
    return h & 0xFFFFu;
  };
  std::vector<int32_t> head(65536, -1), nxt(p);
  for (int64_t j = 0; j < p; ++j) {
    const uint32_t h = hash_tail(patterns + j * m + m - 1);
    // skip duplicate patterns (cannot change the >=1-per-window count but
    // would lengthen every miss's chain walk)
    bool dup = false;
    for (int32_t k = head[h]; k >= 0; k = nxt[k]) {
      if (memcmp(patterns + (int64_t)k * m, patterns + j * m, (size_t)m) == 0) {
        dup = true;
        break;
      }
    }
    if (dup) continue;
    nxt[j] = head[h];
    head[h] = (int32_t)j;
  }
  // scan window ends [m-1, n) split across threads (disjoint end ranges sum
  // exactly — each end is owned by one thread)
  auto scan_range = [&](int64_t e0, int64_t e1, int64_t* out) {
    int64_t c = 0;
    for (int64_t e = e0; e < e1; ++e) {
      const uint32_t h = hash_tail(text + e);
      for (int32_t j = head[h]; j >= 0; j = nxt[j]) {
        if (memcmp(text + e - m + 1, patterns + (int64_t)j * m,
                   (size_t)m) == 0) {
          ++c;
          break;
        }
      }
    }
    *out = c;
  };
  const int64_t total_ends = n - (m - 1);
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? (int64_t)hw : 1;
  if (nt > total_ends / (1 << 16)) nt = total_ends / (1 << 16);  // small texts
  if (nt <= 1) {
    int64_t c = 0;
    scan_range(m - 1, n, &c);
    return c;
  }
  std::vector<int64_t> partial(nt, 0);
  std::vector<std::thread> threads;
  const int64_t per = (total_ends + nt - 1) / nt;
  for (int64_t t = 0; t < nt; ++t) {
    const int64_t e0 = m - 1 + t * per;
    const int64_t e1 = std::min(n, e0 + per);
    threads.emplace_back(scan_range, e0, e1, &partial[t]);
  }
  for (auto& th : threads) th.join();
  for (int64_t t = 0; t < nt; ++t) count += partial[t];
  return count;
}

// CPU match ENUMERATION with pattern attribution — the full-size oracle that
// a scanner's matches() is held against: every window start whose window
// equals >= 1 pattern, with the SMALLEST matching original pattern id (the
// id the reference's verify loops compute but only count, wu/wu.c:184-201).
// Same tail-hash bucketing as tpu_count_cpu, but chains are built in
// DESCENDING id order (head inserts), so the first memcmp hit on a walk is
// the smallest id.  Two-pass threading: disjoint end ranges count, prefix
// offsets, then fill — output is position-sorted by construction.
// Returns the match total (callers size out_pos/out_id from a prior
// tpu_count_cpu call); -1 if the provided capacity is too small.
int64_t tpu_match_enum(const uint8_t* text, int64_t n, const uint8_t* patterns,
                       int64_t p, int64_t m, int64_t* out_pos,
                       int32_t* out_id, int64_t cap) {
  if (n < m || p == 0 || m <= 0) return 0;
  if (m == 1) {
    int32_t first[256];
    for (int i = 0; i < 256; ++i) first[i] = -1;
    for (int64_t j = p - 1; j >= 0; --j) first[patterns[j]] = (int32_t)j;
    int64_t c = 0;
    for (int64_t i = 0; i < n; ++i) {
      if (first[text[i]] >= 0) {
        if (c >= cap) return -1;
        out_pos[c] = i;
        out_id[c] = first[text[i]];
        ++c;
      }
    }
    return c;
  }
  const int64_t kb = m < 16 ? m : 16;
  auto hash_tail = [kb](const uint8_t* end_m1) {
    uint32_t h = 0;
    for (int64_t k = 0; k < kb; ++k) h = h * 131u + end_m1[-k];
    return h & 0xFFFFu;
  };
  std::vector<int32_t> head(65536, -1), nxt(p);
  for (int64_t j = p - 1; j >= 0; --j) {     // descending: chains ascend
    const uint32_t h = hash_tail(patterns + j * m + m - 1);
    nxt[j] = head[h];
    head[h] = (int32_t)j;
  }
  auto match_at = [&](int64_t e) -> int32_t {
    const uint32_t h = hash_tail(text + e);
    for (int32_t j = head[h]; j >= 0; j = nxt[j]) {
      if (memcmp(text + e - m + 1, patterns + (int64_t)j * m,
                 (size_t)m) == 0)
        return j;                            // ascending chain: smallest id
    }
    return -1;
  };
  const int64_t total_ends = n - (m - 1);
  unsigned hw = std::thread::hardware_concurrency();
  int64_t nt = hw ? (int64_t)hw : 1;
  if (nt > total_ends / (1 << 16)) nt = total_ends / (1 << 16);
  if (nt <= 1) {
    int64_t c = 0;
    for (int64_t e = m - 1; e < n; ++e) {
      const int32_t j = match_at(e);
      if (j >= 0) {
        if (c >= cap) return -1;
        out_pos[c] = e - m + 1;
        out_id[c] = j;
        ++c;
      }
    }
    return c;
  }
  const int64_t per = (total_ends + nt - 1) / nt;
  std::vector<int64_t> cnt(nt, 0);
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; ++t) {
      threads.emplace_back([&, t]() {
        const int64_t e0 = m - 1 + t * per;
        const int64_t e1 = std::min(n, e0 + per);
        int64_t c = 0;
        for (int64_t e = e0; e < e1; ++e) c += match_at(e) >= 0;
        cnt[t] = c;
      });
    }
    for (auto& th : threads) th.join();
  }
  std::vector<int64_t> off(nt + 1, 0);
  for (int64_t t = 0; t < nt; ++t) off[t + 1] = off[t] + cnt[t];
  if (off[nt] > cap) return -1;
  {
    std::vector<std::thread> threads;
    for (int64_t t = 0; t < nt; ++t) {
      threads.emplace_back([&, t]() {
        const int64_t e0 = m - 1 + t * per;
        const int64_t e1 = std::min(n, e0 + per);
        int64_t o = off[t];
        for (int64_t e = e0; e < e1; ++e) {
          const int32_t j = match_at(e);
          if (j >= 0) {
            out_pos[o] = e - m + 1;
            out_id[o] = j;
            ++o;
          }
        }
      });
    }
    for (auto& th : threads) th.join();
  }
  return off[nt];
}

// FASTA/raw corpus encoder (the reference's data path is C — the missing
// helper2 load_files; core/corpus.py's vectorised encode_fasta is the numpy
// fallback of load_fasta).
// lut[b]: code point for raw byte b, or 255 = skip (whitespace).  '>' header
// lines are skipped to end-of-line.  Returns encoded length (<= n).
int64_t tpu_encode_fasta(const uint8_t* in, int64_t n, const uint8_t* lut,
                         uint8_t* out) {
  int64_t o = 0;
  int64_t i = 0;
  bool line_start = true;   // '>' marks a header ONLY at line start (FASTA
                            // spec; keeps parity with the numpy fallback,
                            // corpus.header_bytes)
  while (i < n) {
    const uint8_t b = in[i];
    if (b == '>' && line_start) {         // skip header line via memchr
      const void* nl = memchr(in + i, '\n', (size_t)(n - i));
      i = nl ? (int64_t)((const uint8_t*)nl - in) : n;
      continue;                           // the '\n' itself is consumed below
    }
    line_start = (b == '\n');
    const uint8_t v = lut[b];
    out[o] = v;                           // branchless emit
    o += (v != 255);
    ++i;
  }
  return o;
}

// Wu-Manber SHIFT + last-gram hashes + PREFIX bucket sizes (pass 1).
// H = wu_determine_shiftsize(sigma) (wu/wu.c:18-47), computed by the caller;
// the hash is the reference's 2-bit block hash ((c0<<2)+c1<<2)+c2
// (wu/wu.c:64-67).  shift (H,) initialized to m-B+1 then min-updated for
// every pattern position q in [B, m] with m-q (wu/wu.c:221-233).
int64_t tpu_build_wm_shift(const uint8_t *pats, int64_t p, int64_t m,
                           int64_t sigma, int64_t H, int32_t *shift,
                           int32_t *h_last, int32_t *prefix_size) {
  constexpr int64_t B = 3;
  if (m < B) return -1;
  std::fill(shift, shift + H, (int32_t)(m - B + 1));
  std::fill(prefix_size, prefix_size + H, 0);
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    for (int64_t i = 0; i < m; ++i)
      if (pat[i] >= sigma) return -1;
    for (int64_t q = B; q <= m; ++q) {
      const int32_t h = ((((int32_t)pat[q - 3] << 2) + pat[q - 2]) << 2)
                        + pat[q - 1];
      const int32_t len = (int32_t)(m - q);
      if (len < shift[h]) shift[h] = len;
      if (q == m) {
        h_last[j] = h;
        ++prefix_size[h];
      }
    }
  }
  return 0;
}

// Wu-Manber PREFIX lists (pass 2): value = 2-char prefix hash, index =
// pattern id, in reference insertion order (wu/wu.c:236-246); (H, lmax)
// padded with -1, lmax from pass 1's max bucket size.
int64_t tpu_fill_wm_prefix(const uint8_t *pats, int64_t p, int64_t m,
                           const int32_t *h_last, int64_t H, int64_t lmax,
                           int32_t *prefix_value, int32_t *prefix_index) {
  std::fill(prefix_value, prefix_value + H * lmax, -1);
  std::fill(prefix_index, prefix_index + H * lmax, -1);
  std::vector<int32_t> slot(H, 0);
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    const int32_t h = h_last[j];
    const int32_t s = slot[h]++;
    if (s >= lmax) return -1;
    prefix_value[(int64_t)h * lmax + s] =
        ((int32_t)pat[0] << 2) + pat[1];
    prefix_index[(int64_t)h * lmax + s] = (int32_t)j;
  }
  return 0;
}

// SOG T table over the base-sigma gram relabeling (sigma^3 entries; the
// reference's 2^24-entry byte-packed T8, sog/sog8.c:140-147): bit i of
// T[gram] cleared iff some pattern holds that 3-gram at offset i.
int64_t tpu_build_sog(const uint8_t *pats, int64_t p, int64_t m,
                      int64_t sigma, int64_t width, uint32_t *T) {
  constexpr int64_t B = 3;
  if (m != width || (width != 8 && width != 16 && width != 32)) return -1;
  const uint32_t full = (width == 32) ? 0xFFFFFFFFu
                                      : ((1u << width) - 1u);
  const int64_t tsize = sigma * sigma * sigma;
  std::fill(T, T + tsize, full);
  for (int64_t j = 0; j < p; ++j) {
    const uint8_t *pat = pats + j * m;
    for (int64_t i = 0; i < m; ++i)
      if (pat[i] >= sigma) return -1;
    for (int64_t i = 0; i + B <= m; ++i) {
      const int64_t g = (int64_t)pat[i] + (int64_t)pat[i + 1] * sigma
                        + (int64_t)pat[i + 2] * sigma * sigma;
      T[g] &= ~(1u << i);
    }
  }
  return 0;
}

}  // extern "C"
