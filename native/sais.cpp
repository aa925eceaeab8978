// SA-IS linear-time suffix array construction (Nong, Zhang & Chan 2009),
// implemented from the published algorithm for the gwa index builder
// (SURVEY.md §2 #4; reference parity: UInt32SAIS).  The aligner's offline
// index build is the only native-hot-loop in the reference design; on the
// rebuild it stays host-side and feeds packed tables to device memory.
//
// Exposed C ABI (ctypes):
//   int gwa_sais_u8(const uint8_t* codes, int32_t* sa_out, int64_t m)
//     codes: m bases with values 0..3 (2-bit DNA codes)
//     sa_out: m+1 entries; suffix array of codes+sentinel ($ smallest)
//     returns 0 on success.  Requires m+1 <= INT32_MAX.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename C, typename I>
void get_counts(const C* s, I* cnt, I n, I K) {
  std::memset(cnt, 0, sizeof(I) * K);
  for (I i = 0; i < n; i++) cnt[s[i]]++;
}

template <typename I>
void get_buckets(const I* cnt, I* bkt, I K, bool end) {
  I sum = 0;
  for (I c = 0; c < K; c++) {
    sum += cnt[c];
    bkt[c] = end ? sum : sum - cnt[c];
  }
}

// type array: true = S-type
template <typename C, typename I>
void classify(const C* s, std::vector<bool>& t, I n) {
  t[n - 1] = true;  // sentinel is S
  for (I i = n - 2; i >= 0; i--) {
    t[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && t[i + 1]);
    if (i == 0) break;
  }
}

template <typename I>
inline bool is_lms(const std::vector<bool>& t, I i) {
  return i > 0 && t[i] && !t[i - 1];
}

template <typename C, typename I>
void induce_l(const C* s, I* sa, const std::vector<bool>& t, const I* cnt,
              I* bkt, I n, I K) {
  get_buckets(cnt, bkt, K, false);
  for (I i = 0; i < n; i++) {
    I j = sa[i] - 1;
    if (sa[i] > 0 && !t[j]) sa[bkt[s[j]]++] = j;
  }
}

template <typename C, typename I>
void induce_s(const C* s, I* sa, const std::vector<bool>& t, const I* cnt,
              I* bkt, I n, I K) {
  get_buckets(cnt, bkt, K, true);
  for (I i = n - 1; i >= 0; i--) {
    I j = sa[i] - 1;
    if (sa[i] > 0 && t[j]) sa[--bkt[s[j]]] = j;
    if (i == 0) break;
  }
}

// core: s[n-1] must be the unique smallest character (0)
template <typename C, typename I>
void sais_core(const C* s, I* sa, I n, I K) {
  if (n == 1) {
    sa[0] = 0;
    return;
  }
  std::vector<bool> t(n);
  classify(s, t, n);
  std::vector<I> cnt(K), bkt(K);
  get_counts(s, cnt.data(), n, (I)K);

  // ---- stage 1: sort LMS suffixes by induced sorting of LMS positions
  get_buckets(cnt.data(), bkt.data(), (I)K, true);
  for (I i = 0; i < n; i++) sa[i] = -1;
  for (I i = 1; i < n; i++)
    if (is_lms(t, i)) sa[--bkt[s[i]]] = i;
  induce_l(s, sa, t, cnt.data(), bkt.data(), n, (I)K);
  induce_s(s, sa, t, cnt.data(), bkt.data(), n, (I)K);

  // compact sorted LMS positions into sa[0..n1)
  I n1 = 0;
  for (I i = 0; i < n; i++)
    if (is_lms(t, sa[i])) sa[n1++] = sa[i];

  // ---- name LMS substrings in sa[n1..n)
  for (I i = n1; i < n; i++) sa[i] = -1;
  I name = 0, prev = -1;
  for (I i = 0; i < n1; i++) {
    I pos = sa[i];
    bool diff = false;
    if (prev == -1) {
      diff = true;
    } else {
      for (I d = 0;; d++) {
        if (s[pos + d] != s[prev + d] || t[pos + d] != t[prev + d]) {
          diff = true;
          break;
        }
        if (d > 0 && (is_lms(t, (I)(pos + d)) || is_lms(t, (I)(prev + d)))) {
          diff = !(is_lms(t, (I)(pos + d)) && is_lms(t, (I)(prev + d)));
          break;
        }
      }
    }
    if (diff) {
      name++;
      prev = pos;
    }
    sa[n1 + pos / 2] = name - 1;
  }
  for (I i = n - 1, j = n - 1; i >= n1; i--) {
    if (sa[i] >= 0) sa[j--] = sa[i];
    if (i == 0) break;
  }

  // ---- stage 2: recurse if names are not yet unique
  I* sa1 = sa;
  I* s1 = sa + n - n1;
  if (name < n1) {
    sais_core<I, I>(s1, sa1, n1, name);
  } else {
    for (I i = 0; i < n1; i++) sa1[s1[i]] = i;
  }

  // ---- stage 3: induce the full SA from the sorted LMS order
  // restore LMS positions in text order into s1
  for (I i = 1, j = 0; i < n; i++)
    if (is_lms(t, i)) s1[j++] = i;
  for (I i = 0; i < n1; i++) sa1[i] = s1[sa1[i]];
  for (I i = n1; i < n; i++) sa[i] = -1;
  get_buckets(cnt.data(), bkt.data(), (I)K, true);
  for (I i = n1 - 1; i >= 0; i--) {
    I j = sa[i];
    sa[i] = -1;
    sa[--bkt[s[j]]] = j;
    if (i == 0) break;
  }
  induce_l(s, sa, t, cnt.data(), bkt.data(), n, (I)K);
  induce_s(s, sa, t, cnt.data(), bkt.data(), n, (I)K);
}

}  // namespace

extern "C" {

int gwa_sais_u8(const uint8_t* codes, int32_t* sa_out, int64_t m) {
  if (m < 0 || m + 1 > INT32_MAX) return 1;
  int32_t n = (int32_t)(m + 1);
  std::vector<uint8_t> s((size_t)n);
  for (int64_t i = 0; i < m; i++) {
    if (codes[i] > 3) return 2;
    s[(size_t)i] = (uint8_t)(codes[i] + 1);
  }
  s[(size_t)m] = 0;  // sentinel, unique smallest
  sais_core<uint8_t, int32_t>(s.data(), sa_out, n, (int32_t)5);
  return 0;
}

// BWT straight from codes: bwt_out gets m codes (the packed-BWT order with
// the $ row dropped); *primary_out = row index of $.  One pass, avoids a
// second python-side gather over the SA.
int gwa_bwt_u8(const uint8_t* codes, const int32_t* sa, uint8_t* bwt_out,
               int64_t m, int64_t* primary_out) {
  int64_t w = 0;
  *primary_out = -1;
  for (int64_t i = 0; i < m + 1; i++) {
    int32_t v = sa[i];
    if (v == 0) {
      *primary_out = i;
    } else {
      bwt_out[w++] = codes[v - 1];
    }
  }
  return (*primary_out >= 0 && w == m) ? 0 : 1;
}
}
