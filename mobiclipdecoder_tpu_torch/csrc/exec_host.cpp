// Host build of the executor's per-op logic (exec_ops.cuh), for the CPU
// tests only: the loop over thread indices in MOBI_PAR runs the kernel's
// code on the host, so its arithmetic, its plane accessor and its copies
// ahead are checked against the plain PyTorch executor before they reach a
// GPU.  Either plane form can be forced at any geometry.
//
// The cluster form runs each block of a stream's cluster as a coroutine
// (ucontext) with shared memory of its own; a block yields at each
// macroblock's wait and at each cluster barrier, and the scheduler resumes,
// of the blocks whose waits hold, the one whose macroblock (m, c) comes
// first in a wavefront order: by level c + 2m, rows descending within a
// level (order 0) or ascending (order 1); or the lowest row first (order 2),
// so that each row runs as soon as its waits let it, with the rows above it
// as little ahead as those waits allow.  So the kernel's waits are held to
// orders that differ from the decode order; a wait that could never hold
// is reported, never run around.
//   g++ -O3 -std=c++17 -shared -fPIC -o libexec_host.so exec_host.cpp
#include <stdlib.h>
#include <ucontext.h>

#include <vector>

#include "exec_ops.cuh"

extern "C" int mobi_gop_executor_host_smem_bytes(int H, int S, int smem_plane) {
  return mobi_smem_bytes(H, S, smem_plane);
}

extern "C" int mobi_gop_executor_host_cluster_smem_bytes(int H, int S, int C) {
  return mobi_cl_smem_bytes(H, S, C);
}

static MobiArgs mobi_args(const int32_t* ops, const int32_t* resid, uint8_t* ring,
                          uint8_t* frames, const uint8_t* tabs, int B, int nct, int F,
                          int H, int S) {
  MobiArgs a;
  a.ops = ops;
  a.resid = resid;
  a.ring = ring;
  a.frames = frames;
  a.tabs = tabs;
  a.B = B;
  a.nct = nct;
  a.F = F;
  a.H = H;
  a.S = S;
  return a;
}

extern "C" int mobi_gop_executor_host(const int32_t* ops, const int32_t* resid,
                                      uint8_t* ring, uint8_t* frames,
                                      const uint8_t* tabs, int B, int nct, int F,
                                      int H, int S, int smem_plane) {
  const MobiArgs a = mobi_args(ops, resid, ring, frames, tabs, B, nct, F, H, S);
  const size_t bytes = ((size_t)mobi_smem_bytes(H, S, smem_plane) + 15) / 16 * 16;
  uint8_t* smem = static_cast<uint8_t*>(aligned_alloc(16, bytes));
  if (smem == nullptr) return 1;
  for (int b = 0; b < B; ++b) {
    if (smem_plane)
      mobi_run_stream<true>(a, b, smem);
    else
      mobi_run_stream<false>(a, b, smem);
  }
  free(smem);
  return 0;
}

namespace {

struct HostCluster;

// The cluster's synchronisation on the host: see the head of this file.
struct HostSync {
  uint8_t* const* peer;
  HostCluster* cl;
  int rank;
  void publish(MobiClState* cs, int v) { cs->prog = v; }
  void wait(MobiClState* cs, int m, int col, int nmb, int vcorner, int shift, int& seen, int u);
  void cluster_sync();
};

enum { RUN, READY, WAIT, BARRIER, DONE };

struct HostCluster {
  MobiArgs a;
  int b, C, shift, nmb, order;
  std::vector<uint8_t*> smem, rows;
  std::vector<std::vector<char>> stacks;
  std::vector<ucontext_t> ctx;
  ucontext_t main;
  std::vector<int> state, wm, wc;

  MobiClState* cs(int k) const {
    return reinterpret_cast<MobiClState*>(smem[k] + sizeof(MobiStage));
  }
  bool ready(int k) const {
    int q[2], v[2];
    const int n = mobi_cl_needs(wm[k], wc[k], nmb, mobi_cl_vcorner(cs(k), wm[k]), q, v);
    for (int j = 0; j < n; ++j)
      if (cs(q[j] & (C - 1))->prog < v[j]) return false;
    return true;
  }
  // The block to resume, or -1 when none can go on.
  int pick() {
    for (int k = 0; k < C; ++k)
      if (state[k] == READY) return k;
    int best = -1;
    long key = 0;
    for (int k = 0; k < C; ++k) {
      if (state[k] != WAIT || !ready(k)) continue;
      const long kk = order == 2 ? (long)(1023 - wm[k]) * 1024 + wc[k]
                                 : (long)(wc[k] + 2 * wm[k]) * 1024 + (order ? wm[k] : 1023 - wm[k]);
      if (best < 0 || kk < key) {
        best = k;
        key = kk;
      }
    }
    if (best >= 0) return best;
    bool any = false;
    for (int k = 0; k < C; ++k) {
      if (state[k] == BARRIER) any = true;
      else if (state[k] != DONE) return -1;
    }
    if (!any) return -1;
    for (int k = 0; k < C; ++k)
      if (state[k] == BARRIER) state[k] = READY;
    return pick();
  }
  void yield(int k, int s) {
    state[k] = s;
    swapcontext(&ctx[k], &main);
  }
};

thread_local HostCluster* mobi_host_cluster = nullptr;

// The first copying thread yields; the others run after it was resumed.
void HostSync::wait(MobiClState*, int m, int col, int, int, int, int&, int u) {
  if (u != 0) return;
  cl->wm[rank] = m;
  cl->wc[rank] = col;
  cl->yield(rank, WAIT);
}

void HostSync::cluster_sync() { cl->yield(rank, BARRIER); }

void mobi_host_block(int rank) {
  HostCluster* cl = mobi_host_cluster;
  HostSync sy{cl->rows.data(), cl, rank};
  mobi_run_cluster(cl->a, cl->b, rank, cl->shift, cl->smem[rank], sy);
  cl->state[rank] = DONE;
}

}  // namespace

// The cluster form of C blocks (a power of two up to 16), stream by
// stream, in wavefront order `order`.  Returns 0; 1 for a size the form
// does not take; 2 if the blocks' waits stopped every block.
extern "C" int mobi_gop_executor_host_cluster(const int32_t* ops, const int32_t* resid,
                                              uint8_t* ring, uint8_t* frames,
                                              const uint8_t* tabs, int B, int nct, int F,
                                              int H, int S, int C, int order) {
  int shift = 0;
  while (shift < 4 && (1 << shift) < C) ++shift;
  if ((1 << shift) != C || H / 16 > MOBI_CL_MAXR) return 1;
  const size_t bytes = ((size_t)mobi_cl_smem_bytes(H, S, C) + 15) / 16 * 16;
  const size_t stack = 1 << 20;
  int rc = 0;
  for (int b = 0; b < B && rc == 0; ++b) {
    HostCluster cl;
    cl.a = mobi_args(ops, resid, ring, frames, tabs, B, nct, F, H, S);
    cl.b = b;
    cl.C = C;
    cl.shift = shift;
    cl.nmb = H / 16;
    cl.order = order;
    cl.smem.assign(C, nullptr);
    cl.rows.assign(C, nullptr);
    cl.stacks.assign(C, std::vector<char>(stack));
    cl.ctx.resize(C);
    cl.state.assign(C, READY);
    cl.wm.assign(C, 0);
    cl.wc.assign(C, 0);
    mobi_host_cluster = &cl;
    for (int k = 0; k < C; ++k) {
      cl.smem[k] = static_cast<uint8_t*>(aligned_alloc(16, bytes));
      cl.rows[k] = cl.smem[k] + sizeof(MobiStage) + sizeof(MobiClState);
      getcontext(&cl.ctx[k]);
      cl.ctx[k].uc_stack.ss_sp = cl.stacks[k].data();
      cl.ctx[k].uc_stack.ss_size = stack;
      cl.ctx[k].uc_link = &cl.main;
      makecontext(&cl.ctx[k], reinterpret_cast<void (*)()>(mobi_host_block), 1, k);
    }
    for (int k; (k = cl.pick()) >= 0;) {
      cl.state[k] = RUN;
      swapcontext(&cl.main, &cl.ctx[k]);
    }
    for (int k = 0; k < C; ++k) {
      if (cl.state[k] != DONE) rc = 2;
      free(cl.smem[k]);
    }
    mobi_host_cluster = nullptr;
  }
  return rc;
}
