// Approximate Minimum Degree ordering.
//
// From-scratch implementation of the published AMD algorithm (Amestoy, Davis,
// Duff, "An Approximate Minimum Degree Ordering Algorithm"): quotient-graph
// elimination with approximate external degrees, element absorption, mass
// elimination, and hash-based supervariable detection.  The reference vendors
// a templated port of the original code (pre/amd.hpp); this version uses a
// simpler vector-of-vectors quotient graph representation and degree buckets.
//
// Input: symmetric adjacency pattern in CSR (diagonal entries ignored).
// Output: perm[k] = k-th pivot (original index), i.e. A[perm,perm] has low
// fill for LDU.

#include "common.hpp"

#include <chrono>
#include <cstdio>

namespace {

struct AmdGraph {
  i64 n;
  std::vector<std::vector<i32>> adjA;   // variable -> variable neighbors
  std::vector<std::vector<i32>> adjE;   // variable -> element neighbors
  std::vector<std::vector<i32>> elemL;  // element -> member variables
  std::vector<i32> nv;        // supervariable weight (0 => dead)
  std::vector<char> is_elem;  // node became an element (eliminated pivot)
  std::vector<char> dead;     // absorbed into another supervariable/element
  std::vector<i64> deg;       // approximate external degree (weighted)
  // degree buckets (doubly linked)
  std::vector<i32> head, nxt, prv;
  std::vector<i64> in_deg;  // bucket a var currently sits in, -1 if none
  // supervariable member chain: rep -> linked list of original nodes
  std::vector<i32> sv_head, sv_next, sv_tail;

  explicit AmdGraph(i64 n_) : n(n_), adjA(n_), adjE(n_), elemL(n_),
      nv(n_, 1), is_elem(n_, 0), dead(n_, 0), deg(n_, 0),
      head(n_ + 1, -1), nxt(n_, -1), prv(n_, -1), in_deg(n_, -1),
      sv_head(n_), sv_next(n_, -1), sv_tail(n_) {
    for (i64 i = 0; i < n_; ++i) {
      sv_head[i] = (i32)i;
      sv_tail[i] = (i32)i;
    }
  }

  void bucket_insert(i32 i) {
    i64 d = std::min<i64>(deg[i], n);
    nxt[i] = head[d];
    prv[i] = -1;
    if (head[d] >= 0) prv[head[d]] = i;
    head[d] = i;
    in_deg[i] = d;
  }
  void bucket_remove(i32 i) {
    if (in_deg[i] < 0) return;
    if (prv[i] >= 0) nxt[prv[i]] = nxt[i];
    else head[in_deg[i]] = nxt[i];
    if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
    in_deg[i] = -1;
  }
};

}  // namespace

HT_API int ht_amd_vv(i64 n, const i64 *indptr, const i32 *indices, i64 *perm) {
  if (n == 0) return 0;
  AmdGraph g(n);

  for (i64 i = 0; i < n; ++i) {
    auto &a = g.adjA[i];
    a.reserve(indptr[i + 1] - indptr[i]);
    for (i64 k = indptr[i]; k < indptr[i + 1]; ++k)
      if (indices[k] != i) a.push_back(indices[k]);
    g.deg[i] = (i64)a.size();
  }
  // tie rule A/B: HT_AMD_TIE=1 -> forward insertion (highest index at head)
  if (std::getenv("HT_AMD_TIE") && std::getenv("HT_AMD_TIE")[0] == '1')
    for (i64 i = 0; i < n; ++i) g.bucket_insert((i32)i);
  else
    for (i64 i = n - 1; i >= 0; --i) g.bucket_insert((i32)i);
  // exact live weight of each element's member set, maintained
  // incrementally: set at element formation; unchanged by supervariable
  // merges (the merged pair has identical element sets, weight just moves
  // between the two) and by mass elimination (the absorbed variable is a
  // member of the new element only); elements adjacent to an eliminated
  // pivot are absorbed and die.  Replaces the O(|L_e|) member rescans in
  // the w-trick and the esum fallback.
  std::vector<i64> elem_w(n, 0);

  std::vector<i64> w(n, -1);        // |L_e \ Lp| workspace
  std::vector<i64> mark(n, -1);     // membership stamp
  std::vector<i32> Lp;              // members of the new element
  std::vector<i32> scanned_elems;   // elements seen by the w trick
  std::vector<i64> stamp_hash(n, -1);
  std::vector<i32> hash_bucket_head(n, -1), hash_next(n, -1);
  i64 stamp = 0;

  std::vector<i32> elim_order;
  elim_order.reserve(n);
  // assembly tree: parent[e] = element that absorbed e; fsize[e] = front
  // size at elimination (pivot weight + |Lp| weight) for the postorder
  // largest-child-last heuristic (amd_2 runs the same postorder pass)
  std::vector<i32> parent(n, -1);
  std::vector<i64> fsize(n, 0);
  i64 n_live = n;       // count of live supervariables
  i64 live_weight = n;  // total weight of live variables
  i64 mindeg = 0;

  while (n_live > 0) {
    // --- pick min-degree supervariable -----------------------------------
    while (mindeg <= n && g.head[mindeg] < 0) ++mindeg;
    if (mindeg > n) break;  // should not happen
    i32 p = g.head[mindeg];
    g.bucket_remove(p);
    const i64 nvp0 = g.nv[p];

    // --- form element p: Lp = (A_p ∪ ∪_{e∈E_p} L_e) \ dead \ {p} ----------
    ++stamp;
    Lp.clear();
    mark[p] = stamp;
    for (i32 v : g.adjA[p]) {
      if (g.dead[v] || g.is_elem[v] || g.nv[v] == 0) continue;
      if (mark[v] != stamp) {
        mark[v] = stamp;
        Lp.push_back(v);
      }
    }
    for (i32 e : g.adjE[p]) {
      if (!g.is_elem[e] || g.dead[e]) continue;
      for (i32 v : g.elemL[e]) {
        if (g.dead[v] || g.nv[v] == 0 || v == p) continue;
        if (mark[v] != stamp) {
          mark[v] = stamp;
          Lp.push_back(v);
        }
      }
      g.dead[e] = 1;  // absorb e into p
      parent[e] = p;
      g.elemL[e].clear();
      g.elemL[e].shrink_to_fit();
    }
    // p becomes an element with members Lp
    g.is_elem[p] = 1;
    {
      i64 tw = 0;
      for (i32 v : Lp) tw += g.nv[v];
      elem_w[p] = tw;
    }
    g.elemL[p].assign(Lp.begin(), Lp.end());
    g.adjA[p].clear();
    g.adjA[p].shrink_to_fit();
    g.adjE[p].clear();
    g.adjE[p].shrink_to_fit();
    elim_order.push_back(p);
    n_live -= 1;  // p's supervariable leaves the graph
    live_weight -= nvp0;

    const i64 lp_weight = elem_w[p];
    fsize[p] = nvp0 + lp_weight;

    // --- compute |L_e \ Lp| for elements adjacent to Lp (w trick) ---------
    scanned_elems.clear();
    for (i32 v : Lp)
      for (i32 e : g.adjE[v]) {
        if (!g.is_elem[e] || g.dead[e]) continue;
        if (mark[e] != stamp) {
          w[e] = elem_w[e];
          mark[e] = stamp;
          scanned_elems.push_back(e);
        }
        w[e] -= g.nv[v];
      }
    // aggressive element absorption (amd_2 default, TOMS-837 sec. 3):
    // an element whose member set is covered by Lp (|L_e \ Lp| == 0 by
    // weight) is absorbed into the new element p — its members' E lists
    // prune it below, tightening the esum degree bounds
    for (i32 e : scanned_elems)
      if (w[e] == 0) {
        g.dead[e] = 1;
        parent[e] = p;
        g.elemL[e].clear();
        g.elemL[e].shrink_to_fit();
      }

    // --- update each i in Lp ---------------------------------------------
    // amd_2 semantics (TOMS-837; ref pre/amd.hpp:566-634,684-700): this
    // pass stores only the *scan* degree min(old, Σ|L_e \ Lp| + |A_i|_w);
    // the new element's weight is added AFTER mass elimination and
    // supervariable merging (below), using the post-absorption weight.
    for (i32 i : Lp) {
      // prune A_i: drop dead/eliminated and members of Lp (they're covered
      // by element p now)
      auto &ai = g.adjA[i];
      i64 wpos = 0;
      i64 ai_weight = 0;
      for (i32 u : ai) {
        if (g.dead[u] || g.is_elem[u] || g.nv[u] == 0) continue;
        if (mark[u] == stamp && u != i) continue;  // u ∈ Lp
        if (u == i) continue;
        ai[wpos++] = u;
        ai_weight += g.nv[u];
      }
      ai.resize(wpos);
      // prune E_i: drop absorbed; accumulate Σ|L_e \ Lp|
      auto &ei = g.adjE[i];
      wpos = 0;
      i64 esum = 0;
      for (i32 e : ei) {
        if (!g.is_elem[e] || g.dead[e]) continue;
        ei[wpos++] = e;
        esum += mark[e] == stamp ? w[e] : elem_w[e];
      }
      ei.resize(wpos);
      ei.push_back(p);

      i64 d = std::min(g.deg[i], ai_weight + esum);
      if (d < 0) d = 0;
      g.bucket_remove(i);
      g.deg[i] = d;
    }

    // --- mass elimination + supervariable detection -----------------------
    // hash live members of Lp
    ++stamp;
    for (i32 i : Lp) {
      if (g.dead[i]) continue;
      // mass elimination (amd_2 pre/amd.hpp:684-692): adjacency entirely
      // inside the new element (no surviving A neighbors, element list ==
      // {p}) => eliminate together with p, independent of the degree
      if (g.adjA[i].empty() && g.adjE[i].size() == 1 && g.adjE[i][0] == p) {
        // append i's supervariable to p's elimination output
        g.dead[i] = 1;
        g.nv[p] += g.nv[i];
        live_weight -= g.nv[i];
        elem_w[p] -= g.nv[i];
        g.nv[i] = 0;
        n_live -= 1;
        // chain i's members after p's
        g.sv_next[g.sv_tail[p]] = g.sv_head[i];
        g.sv_tail[p] = g.sv_tail[i];
        continue;
      }
      // hash
      i64 h = 0;
      for (i32 u : g.adjA[i]) h += u;
      for (i32 e : g.adjE[i]) h += e;
      h = ((h % n) + n) % n;
      if (stamp_hash[h] != stamp) {
        stamp_hash[h] = stamp;
        hash_bucket_head[h] = i;
        hash_next[i] = -1;
      } else {
        hash_next[i] = hash_bucket_head[h];
        hash_bucket_head[h] = i;
      }
    }
    // compare within hash buckets (exact set equality)
    for (i32 i : Lp) {
      if (g.dead[i]) continue;
      for (i32 jv = hash_next[i]; jv >= 0; jv = hash_next[jv]) {
        if (g.dead[jv]) continue;
        if (g.adjA[i].size() != g.adjA[jv].size() ||
            g.adjE[i].size() != g.adjE[jv].size())
          continue;
        auto sa = g.adjA[i], sb = g.adjA[jv];
        std::sort(sa.begin(), sa.end());
        std::sort(sb.begin(), sb.end());
        if (sa != sb) continue;
        auto ea = g.adjE[i], eb = g.adjE[jv];
        std::sort(ea.begin(), ea.end());
        std::sort(eb.begin(), eb.end());
        if (ea != eb) continue;
        // merge jv into i
        g.bucket_remove(jv);
        g.dead[jv] = 1;
        g.nv[i] += g.nv[jv];
        g.nv[jv] = 0;
        n_live -= 1;
        g.sv_next[g.sv_tail[i]] = g.sv_head[jv];
        g.sv_tail[i] = g.sv_tail[jv];
        g.adjA[jv].clear();
        g.adjE[jv].clear();
      }
    }
    // reinsert survivors into degree buckets (reversed collection order is
    // the default: with amd_2-style mass elimination it measures
    // dramatically better orderings — poisson-256 optimized fill 8.8 ->
    // 2.45 / 87 -> 75 iters, convdiff 156 -> 88 iters, 1M robust 38 iters
    // vs reference 39; HT_AMD_TIE2=0 restores forward order for A/B);
    // the final approximate degree adds the new element's POST-absorption
    // weight and caps at the live remainder (amd_2 pre/amd.hpp:684-700:
    // deg = min(Degree[i] + degme - nvi, nleft - nvi))
    i64 new_min = n;
    static const bool rev2 = !(std::getenv("HT_AMD_TIE2") &&
                               std::getenv("HT_AMD_TIE2")[0] == '0');
    const i64 lpw_final = elem_w[p];
    for (i64 k2 = 0; k2 < (i64)Lp.size(); ++k2) {
      const i32 i = rev2 ? Lp[Lp.size() - 1 - k2] : Lp[k2];
      if (g.dead[i] || g.nv[i] == 0) continue;
      i64 d = std::min(g.deg[i] + lpw_final - g.nv[i],
                       live_weight - g.nv[i]);
      if (d < 0) d = 0;
      g.deg[i] = d;
      g.bucket_insert(i);
      new_min = std::min(new_min, g.in_deg[i]);
    }
    mindeg = std::min(mindeg, new_min);
    // clear w stamps for elements (lazy via mark/stamp already)
  }

  // --- postorder the assembly tree (largest child last), then expand
  // supervariable chains.  amd_2 postorders too (TOMS-837; reference
  // pre/amd.hpp postorder at :289,:765) — grouping each subtree's pivots
  // contiguously, which measurably improves the multilevel ILU quality
  // over the raw elimination sequence.  HT_AMD_NOPOST=1 disables (A/B).
  std::vector<i32> final_order;
  final_order.reserve(elim_order.size());
  if (std::getenv("HT_AMD_NOPOST")) {
    final_order = elim_order;
  } else {
    std::vector<std::vector<i32>> child(n);
    for (i32 e : elim_order)
      if (parent[e] >= 0) child[parent[e]].push_back(e);
    for (i32 e : elim_order) {
      auto &c = child[e];
      if (c.size() > 1) {
        i64 mx = 0;
        for (i64 t = 1; t < (i64)c.size(); ++t)
          if (fsize[c[t]] > fsize[c[mx]]) mx = t;
        std::swap(c[mx], c.back());
      }
    }
    // iterative DFS postorder; roots in elimination order
    std::vector<std::pair<i32, i64>> stk;
    for (i32 r : elim_order) {
      if (parent[r] >= 0) continue;
      stk.emplace_back(r, 0);
      while (!stk.empty()) {
        auto &[node, ci] = stk.back();
        if (ci < (i64)child[node].size()) {
          i32 nxt_child = child[node][ci];
          ++ci;
          stk.emplace_back(nxt_child, 0);
        } else {
          final_order.push_back(node);
          stk.pop_back();
        }
      }
    }
  }
  i64 k = 0;
  for (i32 rep : final_order)
    for (i32 v = g.sv_head[rep]; v >= 0; v = g.sv_next[v]) perm[k++] = v;
  if (k != n) {
    // leftovers (isolated nodes not picked up) — should not happen, but be
    // safe: append any uneliminated nodes
    std::vector<char> seen(n, 0);
    for (i64 i = 0; i < k; ++i) seen[perm[i]] = 1;
    for (i64 i = 0; i < n; ++i)
      if (!seen[i]) perm[k++] = i;
  }
  return k == n ? 0 : 1;
}

// ---------------------------------------------------------------------------
// Flat-arena AMD: the SAME algorithm and tie rules as ht_amd_vv above
// (bit-identical output, asserted by tests/test_pre.py), with the
// vector-of-vectors quotient graph replaced by one i32 arena holding each
// node's [E-sublist | A-sublist] segment (elements reuse their segment for
// the member list).  The vv version allocates 3n separate heap vectors —
// ~1.2 s of the 1M-row robust factorize was AMD, dominated by allocator
// and pointer-chasing costs; the published amd_2 (TOMS-837, reference
// pre/amd.hpp) uses the same single-workspace layout for the same reason.
// ---------------------------------------------------------------------------

namespace {

struct FlatArena {
  std::vector<i32> iw;
  std::vector<i64> pe;    // segment start (node or element member list)
  std::vector<i32> elen;  // variable: #E entries (E sublist first)
  std::vector<i32> alen;  // variable: #A entries; element: #members
  std::vector<i32> cap;   // segment capacity
  i64 tail = 0;
  std::vector<char> *dead = nullptr;     // live-segment test for GC
  std::vector<char> *is_elem = nullptr;

  // ensure `need` free slots at the arena tail, compacting live segments
  // first when growing would overshoot; returns base offset of the block
  i64 alloc(i64 need, i64 n) {
    if (tail + need > (i64)iw.size()) {
      // garbage-collect: keep live variable segments (elen+alen) and live
      // element member lists (alen), ordered by current offset
      std::vector<std::pair<i64, i32>> segs;
      segs.reserve(n);
      for (i64 v = 0; v < n; ++v) {
        const bool el = (*is_elem)[v];
        const i32 live_len = el ? ((*dead)[v] ? 0 : alen[v])
                                : ((*dead)[v] ? 0 : elen[v] + alen[v]);
        if (live_len > 0)
          segs.emplace_back(pe[v], (i32)v);
        else
          cap[v] = 0;  // stale pe after compaction: force re-alloc on reuse
      }
      std::sort(segs.begin(), segs.end());
      i64 w = 0;
      for (auto &s : segs) {
        const i32 v = s.second;
        const i32 live_len =
            (*is_elem)[v] ? alen[v] : elen[v] + alen[v];
        std::memmove(iw.data() + w, iw.data() + pe[v],
                     live_len * sizeof(i32));
        pe[v] = w;
        cap[v] = live_len;
        w += live_len;
      }
      tail = w;
      if (tail + need > (i64)iw.size())
        iw.resize(std::max<i64>(tail + need + 1024,
                                (i64)(iw.size() * 3 / 2)));
    }
    const i64 base = tail;
    tail += need;
    return base;
  }
};

}  // namespace

HT_API int ht_amd(i64 n, const i64 *indptr, const i32 *indices, i64 *perm) {
  if (n == 0) return 0;
  const bool prof = std::getenv("HT_PROFILE") != nullptr;
  auto tprev = std::chrono::steady_clock::now();
  auto phase_mark = [&](const char *what) {
    if (!prof) return;
    auto now = std::chrono::steady_clock::now();
    std::fprintf(stderr, "[ht_amd] %s=%.0fms\n", what,
                 std::chrono::duration<double, std::milli>(now - tprev)
                     .count());
    tprev = now;
  };

  FlatArena ar;
  std::vector<i32> nv(n, 1);
  std::vector<char> is_elem(n, 0), dead(n, 0);
  std::vector<i64> deg(n, 0);
  std::vector<i32> head(n + 1, -1), nxt(n, -1), prv(n, -1);
  std::vector<i64> in_deg(n, -1);
  std::vector<i32> sv_head(n), sv_next(n, -1), sv_tail(n);
  ar.pe.assign(n, 0);
  ar.elen.assign(n, 0);
  ar.alen.assign(n, 0);
  ar.cap.assign(n, 0);
  ar.dead = &dead;
  ar.is_elem = &is_elem;

  const i64 nnz = indptr[n];
  ar.iw.resize(nnz + 2 * n + 1024);
  {
    i64 w = 0;
    for (i64 i = 0; i < n; ++i) {
      sv_head[i] = (i32)i;
      sv_tail[i] = (i32)i;
      ar.pe[i] = w;
      i32 cnt = 0;
      for (i64 k = indptr[i]; k < indptr[i + 1]; ++k)
        if (indices[k] != i) ar.iw[w + cnt++] = indices[k];
      ar.alen[i] = cnt;
      ar.cap[i] = cnt + 1;  // one spare slot for the first element append
      w += cnt + 1;
      deg[i] = cnt;
    }
    ar.tail = w;
  }

  auto bucket_insert = [&](i32 i) {
    i64 d = std::min<i64>(deg[i], n);
    nxt[i] = head[d];
    prv[i] = -1;
    if (head[d] >= 0) prv[head[d]] = i;
    head[d] = i;
    in_deg[i] = d;
  };
  auto bucket_remove = [&](i32 i) {
    if (in_deg[i] < 0) return;
    if (prv[i] >= 0) nxt[prv[i]] = nxt[i];
    else head[in_deg[i]] = nxt[i];
    if (nxt[i] >= 0) prv[nxt[i]] = prv[i];
    in_deg[i] = -1;
  };

  if (std::getenv("HT_AMD_TIE") && std::getenv("HT_AMD_TIE")[0] == '1')
    for (i64 i = 0; i < n; ++i) bucket_insert((i32)i);
  else
    for (i64 i = n - 1; i >= 0; --i) bucket_insert((i32)i);
  phase_mark("build");

  std::vector<i64> elem_w(n, 0);
  std::vector<i64> w_(n, -1);
  std::vector<i64> mark(n, -1);
  std::vector<i32> Lp;
  std::vector<i32> scanned_elems;
  std::vector<i64> stamp_hash(n, -1);
  std::vector<i32> hash_bucket_head(n, -1), hash_next(n, -1);
  i64 stamp = 0;

  std::vector<i32> elim_order;
  elim_order.reserve(n);
  std::vector<i32> parent(n, -1);
  std::vector<i64> fsize(n, 0);
  std::vector<i32> eb, ab;  // per-update pruned-sublist scratch
  i64 n_live = n;
  i64 live_weight = n;
  i64 mindeg = 0;

  while (n_live > 0) {
    while (mindeg <= n && head[mindeg] < 0) ++mindeg;
    if (mindeg > n) break;
    i32 p = head[mindeg];
    bucket_remove(p);
    const i64 nvp0 = nv[p];

    // --- form element p: Lp = (A_p U U_{e in E_p} L_e) \ dead \ {p} -------
    ++stamp;
    Lp.clear();
    mark[p] = stamp;
    {
      const i64 base = ar.pe[p];
      const i32 el = ar.elen[p], al = ar.alen[p];
      for (i32 k = el; k < el + al; ++k) {
        const i32 v = ar.iw[base + k];
        if (dead[v] || is_elem[v] || nv[v] == 0) continue;
        if (mark[v] != stamp) {
          mark[v] = stamp;
          Lp.push_back(v);
        }
      }
      for (i32 k = 0; k < el; ++k) {
        const i32 e = ar.iw[base + k];
        if (!is_elem[e] || dead[e]) continue;
        const i64 eb2 = ar.pe[e];
        const i32 ml = ar.alen[e];
        for (i32 kk = 0; kk < ml; ++kk) {
          const i32 v = ar.iw[eb2 + kk];
          if (dead[v] || nv[v] == 0 || v == p) continue;
          if (mark[v] != stamp) {
            mark[v] = stamp;
            Lp.push_back(v);
          }
        }
        dead[e] = 1;  // absorb e into p
        parent[e] = p;
        ar.alen[e] = 0;
      }
    }
    is_elem[p] = 1;
    {
      i64 tw = 0;
      for (i32 v : Lp) tw += nv[v];
      elem_w[p] = tw;
    }
    // store p's member list (reuse p's segment when it fits)
    {
      const i64 need = (i64)Lp.size();
      ar.elen[p] = 0;
      ar.alen[p] = 0;  // frees p's old segment for GC purposes
      if (need <= ar.cap[p]) {
        std::memcpy(ar.iw.data() + ar.pe[p], Lp.data(),
                    need * sizeof(i32));
      } else {
        const i64 base = ar.alloc(need, n);
        std::memcpy(ar.iw.data() + base, Lp.data(), need * sizeof(i32));
        ar.pe[p] = base;
        ar.cap[p] = (i32)need;
      }
      ar.alen[p] = (i32)need;
    }
    elim_order.push_back(p);
    n_live -= 1;
    live_weight -= nvp0;

    const i64 lp_weight = elem_w[p];
    fsize[p] = nvp0 + lp_weight;

    // --- |L_e \ Lp| via the w trick ---------------------------------------
    scanned_elems.clear();
    for (i32 v : Lp) {
      const i64 base = ar.pe[v];
      const i32 el = ar.elen[v];
      for (i32 k = 0; k < el; ++k) {
        const i32 e = ar.iw[base + k];
        if (!is_elem[e] || dead[e]) continue;
        if (mark[e] != stamp) {
          w_[e] = elem_w[e];
          mark[e] = stamp;
          scanned_elems.push_back(e);
        }
        w_[e] -= nv[v];
      }
    }
    for (i32 e : scanned_elems)
      if (w_[e] == 0) {
        dead[e] = 1;
        parent[e] = p;
        ar.alen[e] = 0;
      }

    // --- update each i in Lp ----------------------------------------------
    for (i32 i : Lp) {
      const i64 base = ar.pe[i];
      const i32 el = ar.elen[i], al = ar.alen[i];
      // prune A_i (stable), accumulating surviving weight
      ab.clear();
      i64 ai_weight = 0;
      for (i32 k = el; k < el + al; ++k) {
        const i32 u = ar.iw[base + k];
        if (dead[u] || is_elem[u] || nv[u] == 0) continue;
        if (mark[u] == stamp && u != i) continue;  // u in Lp
        if (u == i) continue;
        ab.push_back(u);
        ai_weight += nv[u];
      }
      // prune E_i (stable), accumulating sum |L_e \ Lp|; append p
      eb.clear();
      i64 esum = 0;
      for (i32 k = 0; k < el; ++k) {
        const i32 e = ar.iw[base + k];
        if (!is_elem[e] || dead[e]) continue;
        eb.push_back(e);
        esum += mark[e] == stamp ? w_[e] : elem_w[e];
      }
      eb.push_back(p);
      const i64 need = (i64)eb.size() + (i64)ab.size();
      i64 dst = base;
      if (need > ar.cap[i]) {
        ar.elen[i] = 0;
        ar.alen[i] = 0;  // old segment logically free
        dst = ar.alloc(need + 2, n);
        ar.pe[i] = dst;
        ar.cap[i] = (i32)(need + 2);
      }
      std::memcpy(ar.iw.data() + dst, eb.data(), eb.size() * sizeof(i32));
      std::memcpy(ar.iw.data() + dst + eb.size(), ab.data(),
                  ab.size() * sizeof(i32));
      ar.elen[i] = (i32)eb.size();
      ar.alen[i] = (i32)ab.size();

      i64 d = std::min(deg[i], ai_weight + esum);
      if (d < 0) d = 0;
      bucket_remove(i);
      deg[i] = d;
    }

    // --- mass elimination + supervariable detection -----------------------
    ++stamp;
    for (i32 i : Lp) {
      if (dead[i]) continue;
      const i64 base = ar.pe[i];
      const i32 el = ar.elen[i], al = ar.alen[i];
      if (al == 0 && el == 1 && ar.iw[base] == p) {
        dead[i] = 1;
        nv[p] += nv[i];
        live_weight -= nv[i];
        elem_w[p] -= nv[i];
        nv[i] = 0;
        n_live -= 1;
        sv_next[sv_tail[p]] = sv_head[i];
        sv_tail[p] = sv_tail[i];
        continue;
      }
      i64 h = 0;
      for (i32 k = 0; k < el + al; ++k) h += ar.iw[base + k];
      h = ((h % n) + n) % n;
      if (stamp_hash[h] != stamp) {
        stamp_hash[h] = stamp;
        hash_bucket_head[h] = i;
        hash_next[i] = -1;
      } else {
        hash_next[i] = hash_bucket_head[h];
        hash_bucket_head[h] = i;
      }
    }
    {
      // compare within hash buckets: exact set equality via stamp marking
      // (amd_2 compares by scan too, TOMS-837).  A lists hold variables and
      // E lists hold elements — disjoint id roles — and neither contains
      // duplicates, so marking i's entries once and checking jv's entries
      // all marked (with equal lengths) is exact set equality.  Identical
      // merge decisions to the sorted-copy comparison, no sorts, no allocs.
      for (i32 i : Lp) {
        if (dead[i]) continue;
        bool marked_i = false;
        for (i32 jv = hash_next[i]; jv >= 0; jv = hash_next[jv]) {
          if (dead[jv]) continue;
          if (ar.alen[i] != ar.alen[jv] || ar.elen[i] != ar.elen[jv])
            continue;
          const i64 bi = ar.pe[i], bj = ar.pe[jv];
          const i32 eli = ar.elen[i], ali = ar.alen[i];
          if (!marked_i) {
            ++stamp;
            for (i32 k3 = 0; k3 < eli + ali; ++k3) mark[ar.iw[bi + k3]] = stamp;
            marked_i = true;
          }
          bool same = true;
          for (i32 k3 = 0; k3 < eli + ali; ++k3)
            if (mark[ar.iw[bj + k3]] != stamp) { same = false; break; }
          if (!same) continue;
          bucket_remove(jv);
          dead[jv] = 1;
          nv[i] += nv[jv];
          nv[jv] = 0;
          n_live -= 1;
          sv_next[sv_tail[i]] = sv_head[jv];
          sv_tail[i] = sv_tail[jv];
          ar.elen[jv] = 0;
          ar.alen[jv] = 0;
        }
      }
    }
    // reinsert survivors (same default/env tie rules as ht_amd_vv)
    i64 new_min = n;
    static const bool rev2 = !(std::getenv("HT_AMD_TIE2") &&
                               std::getenv("HT_AMD_TIE2")[0] == '0');
    const i64 lpw_final = elem_w[p];
    for (i64 k2 = 0; k2 < (i64)Lp.size(); ++k2) {
      const i32 i = rev2 ? Lp[Lp.size() - 1 - k2] : Lp[k2];
      if (dead[i] || nv[i] == 0) continue;
      i64 d = std::min(deg[i] + lpw_final - nv[i], live_weight - nv[i]);
      if (d < 0) d = 0;
      deg[i] = d;
      bucket_insert(i);
      new_min = std::min(new_min, in_deg[i]);
    }
    mindeg = std::min(mindeg, new_min);
  }

  phase_mark("mainloop");
  // --- postorder (identical to ht_amd_vv) ---------------------------------
  std::vector<i32> final_order;
  final_order.reserve(elim_order.size());
  if (std::getenv("HT_AMD_NOPOST")) {
    final_order = elim_order;
  } else {
    // flat child lists (counting layout; fill in elim order keeps the
    // same child ordering as the old vector-of-vectors build)
    std::vector<i64> cptr(n + 1, 0);
    for (i32 e : elim_order)
      if (parent[e] >= 0) ++cptr[parent[e] + 1];
    for (i64 v = 0; v < n; ++v) cptr[v + 1] += cptr[v];
    std::vector<i32> cbuf(elim_order.size());
    {
      std::vector<i64> nx2(cptr.begin(), cptr.end() - 1);
      for (i32 e : elim_order)
        if (parent[e] >= 0) cbuf[nx2[parent[e]]++] = e;
    }
    for (i32 e : elim_order) {
      const i64 a = cptr[e], b = cptr[e + 1];
      if (b - a > 1) {
        i64 mx = a;
        for (i64 t = a + 1; t < b; ++t)
          if (fsize[cbuf[t]] > fsize[cbuf[mx]]) mx = t;
        std::swap(cbuf[mx], cbuf[b - 1]);
      }
    }
    std::vector<std::pair<i32, i64>> stk;
    for (i32 r : elim_order) {
      if (parent[r] >= 0) continue;
      stk.emplace_back(r, 0);
      while (!stk.empty()) {
        auto &[node, ci] = stk.back();
        if (ci < cptr[node + 1] - cptr[node]) {
          i32 nxt_child = cbuf[cptr[node] + ci];
          ++ci;
          stk.emplace_back(nxt_child, 0);
        } else {
          final_order.push_back(node);
          stk.pop_back();
        }
      }
    }
  }
  phase_mark("postorder");
  i64 k = 0;
  for (i32 rep : final_order)
    for (i32 v = sv_head[rep]; v >= 0; v = sv_next[v]) perm[k++] = v;
  if (k != n) {
    std::vector<char> seen(n, 0);
    for (i64 i = 0; i < k; ++i) seen[perm[i]] = 1;
    for (i64 i = 0; i < n; ++i)
      if (!seen[i]) perm[k++] = i;
  }
  phase_mark("expand");
  return k == n ? 0 : 1;
}
