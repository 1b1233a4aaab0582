// SA-IS suffix-array construction for the host index build.
//
// Nong, Zhang & Chan, "Two Efficient Algorithms for Linear Time Suffix Array
// Construction" (2009): induced sorting with LMS substrings, over int32 texts
// of fewer than 2^31 chars.  Exposed as a C ABI and
// loaded with ctypes (sahara_tpu_torch/native/__init__.py).

#include <algorithm>
#include <cstdint>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// SA-IS. Paper-faithful implementation, templated on index and character
// type (the recursion sorts a string of names).  The input string MUST end
// with a unique, strictly smallest character (the "sentinel"); the Python
// wrapper guarantees this by shifting ranks +1 and appending 0.
// ---------------------------------------------------------------------------

template <class IdxT, class CharT>
void get_buckets(const CharT* s, IdxT n, IdxT K, IdxT* bkt, bool end) {
    std::fill(bkt, bkt + K, IdxT(0));
    for (IdxT i = 0; i < n; ++i) bkt[s[i]]++;
    IdxT sum = 0;
    for (IdxT c = 0; c < K; ++c) {
        sum += bkt[c];
        bkt[c] = end ? sum : sum - bkt[c];
    }
}

// Induce L-type suffixes scanning left-to-right.
template <class IdxT, class CharT>
void induce_l(const std::vector<bool>& is_s, IdxT* SA, const CharT* s, IdxT n, IdxT K, IdxT* bkt) {
    get_buckets(s, n, K, bkt, /*end=*/false);
    for (IdxT i = 0; i < n; ++i) {
        IdxT j = SA[i] - 1;
        if (SA[i] > 0 && !is_s[j]) SA[bkt[s[j]]++] = j;
    }
}

// Induce S-type suffixes scanning right-to-left.
template <class IdxT, class CharT>
void induce_s(const std::vector<bool>& is_s, IdxT* SA, const CharT* s, IdxT n, IdxT K, IdxT* bkt) {
    get_buckets(s, n, K, bkt, /*end=*/true);
    for (IdxT i = n; i-- > 0;) {
        IdxT j = SA[i] - 1;
        if (SA[i] > 0 && is_s[j]) SA[--bkt[s[j]]] = j;
    }
}

constexpr int64_t EMPTY = -1;

template <class IdxT, class CharT>
void sais_impl(const CharT* s, IdxT* SA, IdxT n, IdxT K) {
    // n >= 1; s[n-1] is the unique smallest character.
    if (n == 1) {
        SA[0] = 0;
        return;
    }

    // 1) classify suffix types: is_s[i] <=> suffix i is S-type.
    std::vector<bool> is_s(n);
    is_s[n - 1] = true;
    for (IdxT i = n - 1; i-- > 0;) {
        is_s[i] = (s[i] < s[i + 1]) || (s[i] == s[i + 1] && is_s[i + 1]);
    }
    auto is_lms = [&](IdxT i) { return i > 0 && is_s[i] && !is_s[i - 1]; };

    std::vector<IdxT> bkt(K);

    // 2) stage 1: sort LMS substrings by one round of induced sorting.
    std::fill(SA, SA + n, IdxT(EMPTY));
    get_buckets(s, n, K, bkt.data(), /*end=*/true);
    for (IdxT i = 1; i < n; ++i) {
        if (is_lms(i)) SA[--bkt[s[i]]] = i;
    }
    induce_l(is_s, SA, s, n, K, bkt.data());
    induce_s(is_s, SA, s, n, K, bkt.data());

    // 3) compact sorted LMS positions into SA[0..n1), name LMS substrings.
    IdxT n1 = 0;
    for (IdxT i = 0; i < n; ++i) {
        if (is_lms(SA[i])) SA[n1++] = SA[i];
    }
    // name buffer lives in the unused upper part of SA
    IdxT* name_of = SA + n1;  // indexed by position/2, size <= n - n1
    std::fill(name_of, SA + n, IdxT(EMPTY));
    IdxT names = 0;
    IdxT prev = EMPTY;
    for (IdxT i = 0; i < n1; ++i) {
        IdxT pos = SA[i];
        bool same = false;
        if (prev != EMPTY) {
            // compare LMS substrings at prev and pos (chars + types until the
            // character AFTER the next LMS position, inclusive)
            IdxT a = prev, b = pos;
            same = true;
            for (IdxT d = 0;; ++d) {
                bool a_end = d > 0 && is_lms(a + d);
                bool b_end = d > 0 && is_lms(b + d);
                if (a_end && b_end) break;
                if (a_end != b_end || s[a + d] != s[b + d] || is_s[a + d] != is_s[b + d]) {
                    same = false;
                    break;
                }
            }
        }
        if (!same) {
            ++names;
            prev = pos;
        }
        name_of[pos / 2] = names - 1;
    }

    // 4) build the reduced string s1 (LMS names in text order) at SA[n-n1..n)
    //    by compacting non-empty names right-to-left (safe in-place: the
    //    write cursor never passes the read cursor).
    IdxT* s1 = SA + (n - n1);
    {
        IdxT j = n - 1;
        for (IdxT i = n; i-- > n1;) {
            if (SA[i] != EMPTY) SA[j--] = SA[i];
        }
    }

    // 5) sort LMS suffixes: recurse if names are not unique.
    IdxT* SA1 = SA;
    if (names < n1) {
        sais_impl<IdxT, IdxT>(s1, SA1, n1, names);
    } else {
        for (IdxT i = 0; i < n1; ++i) SA1[s1[i]] = i;
    }

    // 6) stage 3: put LMS suffixes (now fully sorted) at bucket ends and
    //    induce the rest.
    // rebuild the LMS position list (text order) into s1
    {
        IdxT j = 0;
        for (IdxT i = 1; i < n; ++i) {
            if (is_lms(i)) s1[j++] = i;
        }
    }
    for (IdxT i = 0; i < n1; ++i) SA1[i] = s1[SA1[i]];
    std::fill(SA + n1, SA + n, IdxT(EMPTY));
    get_buckets(s, n, K, bkt.data(), /*end=*/true);
    for (IdxT i = n1; i-- > 0;) {
        IdxT j = SA[i];
        SA[i] = EMPTY;
        SA[--bkt[s[j]]] = j;
    }
    induce_l(is_s, SA, s, n, K, bkt.data());
    induce_s(is_s, SA, s, n, K, bkt.data());
}

}  // namespace

extern "C" {

// Suffix array over int32 text (values in [0,K), text[n-1] unique smallest).
int sahara_sais_i32(const int32_t* s, int32_t* sa, int32_t n, int32_t K) {
    if (n <= 0 || K <= 0) return -1;
    sais_impl<int32_t, int32_t>(s, sa, n, K);
    return 0;
}

}  // extern "C"
