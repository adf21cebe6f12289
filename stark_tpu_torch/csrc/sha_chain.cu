// K5: the flagged, strictly sequential SHA-256 block chain of the
// Fiat-Shamir transcript, and the query phase built around it.
//
// Replaces the TPU kernel stark_tpu/hash/pallas_chain.py
// _make_chain_kernel (driven by _chain_call / sha_chain; hex helper
// _hex_words) and, for the query form, the lax.scan over queries of
// stark_tpu/channel/device_query.py DeviceQueryPlan._run.  Semantics are
// those of device_query._block_step, with one extension for the port's
// device channel:
//
//   flags[i] = (first, last)
//   first == 1: reset the compressor to H0 and hash the 64-char lowercase
//               hex of the chain state instead of row i;
//   first == 2: reset the compressor to H0 and hash row i as it is (the
//               first absorb of a fresh channel, which has no prior state);
//   last  != 0: the compression output becomes the new chain state.
//
// What bounds it on an H100: the latency of one serial chain.  Every
// block depends on the one before, so the time is B compressions back to
// back on one thread, 64 rounds each, and a round's new e is at least
// three dependent integer operations after the last (shift, xor3, add3).
// Design, one block of four warps:
//
// * Warp 0, lane 0 is the chain: compressor and chain state in
//   registers, reading only shared memory.  It computes a message
//   schedule itself only for FIRST_HEX rows, from the hex of its
//   registers; every other row arrives as W[0..63] + K ready to add.
// * Warps 1-3 (96 staging threads) run ahead of it: staging thread p owns
//   ring slot p and fills it with rows p, p + 96, ... (the row's 64 words
//   W + K and its flags), one mbarrier pair per slot (full: slot written;
//   empty: slot read).  So no global load and no schedule word is on the
//   chain's path.
// * stark_sha_chain stages the stream into shared memory in chunks of
//   512 rows with TMA 1-D bulk copies (cp.async.bulk completing on an
//   mbarrier), two chunk buffers, so a stream of any length runs in
//   ~94 KB; the staging threads read each row's 8-byte flags from global
//   memory as they fill its slot, off the chain's path.
// * stark_query_chain runs all queries of the query phase in one launch:
//   for each query the block draws idx = int(state_hex, 16) mod range,
//   gathers every opened value and authentication-path digest through
//   the plan's slot table, writes them as hex into its shared-memory copy
//   of the plan's stream template at the word each slot names (so a trace
//   opening of C columns is one row message of C values), then runs the
//   chain over that stream.
//   Every plan of a u32 field (domains below 2^32) has at most ~1,350
//   rows a query, ~125 KB of shared memory with the ring, so the whole
//   stream stays in shared memory; the wrapper raises for a plan that
//   does not fit.
// * Pruned trees (merkle/tree.py) do not store their first `prune`
//   levels.  Query q + 1's index depends on what query q absorbed, so
//   their siblings are recomputed here, after each draw and before the
//   gather (where the JAX package's scan calls _subtree_sibs,
//   stark_tpu/channel/device_query.py:245-280): for each recompute task
//   (one pruned authentication path) the block's 128 threads hash the
//   aligned 2^prune leaves of the path's leaf from the values, then
//   reduce them level by level in shared memory, one barrier a level for
//   all tasks together; the gather reads the siblings from there like
//   any digest.  The chain is idle meanwhile (the stream it hashes needs
//   them), so the barriers hold back no chain row.  Per query that is
//   one leaf compression a thread (up to 128 leaves at once) and two
//   compressions a level: ~2 prune + 1 compressions on the critical
//   path.
// * Batch (stark/batch.py's B proofs): both forms run one independent
//   block a chain, blockIdx.x the proof.  The chain form reads proof b's
//   rows and flags a fixed stride after proof 0's; the query form shares
//   the plan's tables and reads proof b's values and trees at fixed
//   strides, so the B query phases are one launch on B SMs, each as long
//   as one proof's.  A single chain is the batch of one.
// * Sources (the trace LDE, the trace tree, the FRI values, the FRI
//   trees) are read through a table of entries, each a base address and
//   a per-proof stride in bytes.  A slot names its first entry and the
//   log2 of the lanes one entry holds: lane >> shard picks the entry,
//   the low bits the element.  Unsharded, each source is one entry and
//   the shard field is 62, so the address is today's base + lane.  On a
//   mesh (stark_tpu_torch/dist/) a sharded array is one entry a block,
//   and a sharded tree one entry a subtree plus one for its top levels:
//   each level's slots carry that level's block size, so no slot
//   searches for its level.  Blocks on other cards are read by their
//   unified addresses, with peer access enabled (stark_enable_peer).
//   The JAX package's mesh prove gave up its Pallas chain for the XLA
//   scan here (stark_tpu/stark/prover.py:720-726); this one keeps the
//   kernel.
// * Over a process mesh (one process a card or a few shards, under
//   torch.distributed) no process can address another's blocks, so the
//   query form is cut at the query boundary: launch k chains query k - 1
//   from the slot words the processes summed, then draws query k and
//   gathers the slots this process holds, zeros elsewhere (an entry of
//   address 0); between launches the process group sums query k's words
//   (a few KB).  Every process runs the same chain, so Q queries are Q + 1
//   launches and Q all-reduces, and the chain itself is unchanged.

#include <cstdint>
#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

constexpr int kThreads = 128;       // warp 0: the chain; warps 1-3: staging
constexpr int kStagers = kThreads - 32;
constexpr int kRing = kStagers;     // ring slots: staging thread p owns p
// a slot: 64 words W + K, the row's (first, last), 2 words of padding;
// 68 words keep slots 16-byte aligned and make eight staging threads'
// 16-byte stores hit eight different bank groups
constexpr int kSlotWords = 68;
constexpr int kRingBytes = kRing * kSlotWords * 4;
constexpr int kRingBarBytes = 2 * kRing * 8;
constexpr int kChunk = 512;         // rows per staged chunk (chain form)
constexpr int kChunkBytes = kChunk * 64;
constexpr int kFirstHex = 1;
constexpr int kMaxSmem = 232448;    // an H100 block's dynamic shared memory

// ---- mbarrier and TMA (PTX ISA 8.0, sm_90) ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// make the initialised barriers visible to the other threads and to the
// async proxy (TMA) before anyone uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// release: every earlier access of this thread is ordered before it
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
          smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n\t}" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

// acquire: wait until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  }
}

// TMA 1-D bulk copy global -> shared, completing `bytes` on `bar`
__device__ __forceinline__ void tma_load(void* dst, const void* src,
                                         uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// ---- hex ------------------------------------------------------------

// The 4 lowercase hex chars of the low 16 bits of v, as one big-endian
// word (nibbles spread to bytes, then '0' or 'a' - 10 added per byte).
__device__ __forceinline__ uint32_t hex4(uint32_t v) {
  uint32_t t = (v | (v << 8)) & 0x00FF00FFu;
  t = (t | (t << 4)) & 0x0F0F0F0Fu;
  const uint32_t ge10 = ((t + 0x06060606u) >> 4) & 0x01010101u;
  return t + 0x30303030u + ge10 * 0x27u;
}

// The 8 hex chars of x as two big-endian words of 4 chars each.
__device__ __forceinline__ void hex_words(uint32_t x, uint32_t* out) {
  out[0] = hex4(x >> 16);
  out[1] = hex4(x & 0xFFFFu);
}

// ---- the ring between the staging threads and the chain --------------

struct Ring {
  uint32_t* slots;   // [kRing][kSlotWords]
  uint64_t* full;    // [kRing]
  uint64_t* empty;   // [kRing]
};

__device__ __forceinline__ Ring ring_at(unsigned char* smem) {
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kRingBytes);
  return Ring{reinterpret_cast<uint32_t*>(smem), bars, bars + kRing};
}

__device__ __forceinline__ void ring_init(const Ring& r) {
  if (threadIdx.x < kRing) {
    mbar_init(&r.full[threadIdx.x], 1);
    mbar_init(&r.empty[threadIdx.x], 1);
  }
}

// Staging side: fill `slot` for its use number `use` (0, 1, ...) with
// the row at `row` (16 words, shared or global memory) and its flags.
__device__ __forceinline__ void stage_row(const Ring& r, int slot,
                                          uint32_t use, const uint4* row,
                                          int2 fl) {
  uint32_t w[16];
  if (fl.x != kFirstHex) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint4 v = row[q];
      w[4 * q] = v.x; w[4 * q + 1] = v.y; w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
  }
  mbar_wait(&r.empty[slot], (use & 1u) ^ 1u);
  uint32_t* s = r.slots + slot * kSlotWords;
  if (fl.x != kFirstHex) sha::schedule_kw(w, reinterpret_cast<uint4*>(s));
  *reinterpret_cast<int2*>(s + 64) = fl;
  mbar_arrive(&r.full[slot]);
}

struct Cursor {
  int slot;
  uint32_t parity;
};

// Chain side: run n rows from the ring through the compressor.
__device__ __forceinline__ void chain_rows(const Ring& r, int n,
                                           Cursor& cur, uint32_t st[8],
                                           uint32_t chain[8]) {
  for (int i = 0; i < n; ++i) {
    mbar_wait(&r.full[cur.slot], cur.parity);
    const uint32_t* s = r.slots + cur.slot * kSlotWords;
    const int2 fl = *reinterpret_cast<const int2*>(s + 64);
    if (fl.x == kFirstHex) {
      mbar_arrive(&r.empty[cur.slot]);
      uint32_t w[16];
#pragma unroll
      for (int k = 0; k < 8; ++k) hex_words(chain[k], w + 2 * k);
      sha::init(st);
      sha::compress(st, w);
    } else {
      uint32_t kw[64];
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const uint4 v = reinterpret_cast<const uint4*>(s)[q];
        kw[4 * q] = v.x; kw[4 * q + 1] = v.y; kw[4 * q + 2] = v.z;
        kw[4 * q + 3] = v.w;
      }
      mbar_arrive(&r.empty[cur.slot]);
      if (fl.x != 0) sha::init(st);
      sha::compress_kw(st, kw);
    }
    if (fl.y != 0) {
#pragma unroll
      for (int k = 0; k < 8; ++k) chain[k] = st[k];
    }
    if (++cur.slot == kRing) {
      cur.slot = 0;
      cur.parity ^= 1u;
    }
  }
}

// ---- the chain form --------------------------------------------------

constexpr int kChainSmem = kRingBytes + kRingBarBytes + 2 * kChunkBytes + 32;

__global__ void __launch_bounds__(kThreads, 1)
    sha_chain(const uint4* __restrict__ stream,
              const int2* __restrict__ flags,
              const uint32_t* __restrict__ chain_in,
              uint32_t* __restrict__ chain_out, int nblocks,
              long long stream_stride, long long flag_stride) {
  extern __shared__ __align__(128) unsigned char smem[];
  // chain blockIdx.x: its rows and flags a fixed stride after chain 0's
  stream += static_cast<size_t>(blockIdx.x) * stream_stride * 4;
  flags += static_cast<size_t>(blockIdx.x) * flag_stride;
  chain_in += 8 * blockIdx.x;
  chain_out += 8 * blockIdx.x;
  const Ring r = ring_at(smem);
  uint4* chunks = reinterpret_cast<uint4*>(smem + kRingBytes + kRingBarBytes);
  uint64_t* cfull = reinterpret_cast<uint64_t*>(
      smem + kRingBytes + kRingBarBytes + 2 * kChunkBytes);
  uint64_t* cempty = cfull + 2;
  ring_init(r);
  if (threadIdx.x == 0) {
    mbar_init(&cfull[0], 1);
    mbar_init(&cfull[1], 1);
    mbar_init(&cempty[0], kStagers);
    mbar_init(&cempty[1], kStagers);
  }
  mbar_init_fence();
  __syncthreads();

  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) {
      uint32_t chain[8], st[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) { chain[k] = chain_in[k]; st[k] = 0u; }
      Cursor cur{0, 0u};
      chain_rows(r, nblocks, cur, st, chain);
#pragma unroll
      for (int k = 0; k < 8; ++k) chain_out[k] = chain[k];
    }
    return;
  }

  const int p = threadIdx.x - 32;
  const int nchunks = (nblocks + kChunk - 1) / kChunk;
  auto stage_chunk = [&](int c) {
    const int buf = c & 1;
    const int rows = min(kChunk, nblocks - c * kChunk);
    const uint32_t bytes = static_cast<uint32_t>(rows) * 64u;
    mbar_arrive_expect_tx(&cfull[buf], bytes);
    tma_load(chunks + static_cast<size_t>(buf) * kChunk * 4,
             stream + static_cast<size_t>(c) * kChunk * 4, bytes,
             &cfull[buf]);
  };
  if (p == 0) {
    for (int c = 0; c < min(2, nchunks); ++c) stage_chunk(c);
  }
  uint32_t use = 0;
  for (int i = p; i < nblocks; i += kStagers, ++use) {
    const int c = i / kChunk, buf = c & 1;
    mbar_wait(&cfull[buf], static_cast<uint32_t>(c >> 1) & 1u);
    const uint4* row =
        chunks + (static_cast<size_t>(buf) * kChunk + (i - c * kChunk)) * 4;
    stage_row(r, p, use, row, flags[i]);
    if ((i + kStagers) / kChunk != c) {
      // this thread is done with chunk c; the last of them frees its
      // buffer, and thread 0 of the staging warps refills it with c + 2
      mbar_arrive(&cempty[buf]);
      if (p == 0 && c + 2 < nchunks) {
        mbar_wait(&cempty[buf], static_cast<uint32_t>(c >> 1) & 1u);
        stage_chunk(c + 2);
      }
    }
  }
}

// ---- the query form --------------------------------------------------

// slot table columns (int64): source, base, add, mask, xr, shift, flip,
// stream word; position = base + ((((idx + add) & mask) ^ xr) >> shift)
// ^ flip into the source's buffer, and the slot's hex is written from word
// `word` of the query's (nrows, 16) stream: the 2 hex words of one 32-bit
// word of a value (a u32 value is one slot, at word 4c + 2 of its row
// message's payload after 8 hex zeros of the template, column c at base
// c * M of the (C, M) trace LDE; a Goldilocks value is two, its hi word at
// 4c from the hi plane and its lo word at 4c + 2 from the lo plane), the 16
// of a digest, from global memory or, for the sibling of a pruned level,
// from the query's recomputed nodes in shared memory
enum Source { kTraceValue = 0, kFriValue = 1, kTraceDigest = 2,
              kFriDigest = 3, kTraceSubtree = 4, kFriSubtree = 5 };

// slot columns (int64): slot s reads element
// base + (lane & (2^shard - 1)) of source entry ptab + (lane >> shard),
// lane = ((((idx + add) & mask) ^ xr) >> shift) ^ flip, and writes its hex
// from stream word `word`; a recomputed sibling reads node base + lane
enum SlotColumn { kSlotSource = 0, kSlotPtab, kSlotBase, kSlotAdd, kSlotMask,
                  kSlotXr, kSlotShift, kSlotFlip, kSlotWord, kSlotShard,
                  kSlotColumns };

// recompute task columns (int64), one task a pruned authentication path:
// its leaf j = ((idx + add) & mask) ^ xr in the tree over the values of
// source entry ptab (an unsharded trace LDE or FRI buffer); the task hashes
// leaves ((j >> prune) << prune) + i, i < 2^prune, leaf i the row message
// of `cols` values whose word planes start at base + plane * stride + leaf
// (planes c, or 2c and 2c + 1 in the 64-bit mode), and keeps levels 0 ..
// prune - 1 of that block in shared memory from digest row `node` on,
// level l at node + 2^(prune + 1) - 2^(prune - l + 1)
enum TaskColumn { kTaskPtab = 0, kTaskAdd, kTaskMask, kTaskXr, kTaskPrune,
                  kTaskBase, kTaskStride, kTaskCols, kTaskNode,
                  kTaskColumns };

// shared memory of the query form: the ring, the stream, its flags, the
// published idx, then (16-byte aligned) `nodes` recomputed digest rows
__host__ __device__ constexpr int query_smem_nodes(int nrows) {
  return (kRingBytes + kRingBarBytes + nrows * (64 + 8) + 16 + 15) & ~15;
}

__host__ __device__ constexpr int query_smem(int nrows, int nodes) {
  return query_smem_nodes(nrows) + nodes * 32;
}

// Source entry e for proof b: rows (address, per-proof stride in bytes).
__device__ __forceinline__ const unsigned char* entry(
    const long long* __restrict__ ptrs, long long e, size_t b) {
  return reinterpret_cast<const unsigned char*>(ptrs[2 * e] +
                                                b * ptrs[2 * e + 1]);
}

// The 16 words of a leaf's message: `cols` values, each 8 big-endian
// bytes (hi, lo; a u32 value's hi word 0), then the padding; v points at
// the leaf's word of plane 0, planes `stride` words apart.  Static
// indices throughout, so the message stays in registers.
__device__ __forceinline__ void leaf_message(const uint32_t* v,
                                             long long stride, int cols,
                                             bool wide, uint32_t w[16]) {
#pragma unroll
  for (int k = 0; k < 16; ++k) w[k] = 0u;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    if (c < cols) {
      if (wide) {
        w[2 * c] = v[(2 * c) * stride];
        w[2 * c + 1] = v[(2 * c + 1) * stride];
      } else {
        w[2 * c + 1] = v[c * stride];
      }
    }
  }
#pragma unroll
  for (int k = 2; k < 15; k += 2)
    if (k == 2 * cols) w[k] = 0x80000000u;
  w[15] = 64u * static_cast<uint32_t>(cols);
}

// Levels 0 .. prune - 1 of every task's block for this query's idx, into
// `nodes`: level l of all tasks in one pass of the block's threads, a
// barrier between passes.  The caller's barrier after it publishes the
// last level.
__device__ void recompute_blocks(const long long* __restrict__ tasks,
                                 int ntasks, int max_prune, long long idx,
                                 const long long* __restrict__ ptrs, size_t b,
                                 bool wide, uint4* nodes) {
  for (int l = 0; l < max_prune; ++l) {
    if (l > 0) __syncthreads();  // level l - 1 is complete
    int total = 0;
    for (int t = 0; t < ntasks; ++t) {
      const int p = static_cast<int>(tasks[t * kTaskColumns + kTaskPrune]);
      if (p > l) total += 1 << (p - l);
    }
    for (int i = threadIdx.x; i < total; i += kThreads) {
      // node k of level l of task t
      const long long* t = tasks;
      int k = i, p = 0;
      for (;; t += kTaskColumns) {
        p = static_cast<int>(t[kTaskPrune]);
        const int count = p > l ? 1 << (p - l) : 0;
        if (k < count) break;
        k -= count;
      }
      const long long node = t[kTaskNode];
      uint32_t w[16], st[8];
      if (l == 0) {
        const long long j = ((idx + t[kTaskAdd]) & t[kTaskMask]) ^ t[kTaskXr];
        const uint32_t* v =
            reinterpret_cast<const uint32_t*>(entry(ptrs, t[kTaskPtab], b)) +
            t[kTaskBase] + ((j >> p) << p) + k;
        leaf_message(v, t[kTaskStride], static_cast<int>(t[kTaskCols]), wide,
                     w);
        sha::init(st);
        sha::compress(st, w);
      } else {
        const uint4* kids =
            nodes + 2 * (node + (2 << p) - (2 << (p - l + 1)) + 2 * k);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 c = kids[q];
          w[4 * q] = c.x; w[4 * q + 1] = c.y; w[4 * q + 2] = c.z;
          w[4 * q + 3] = c.w;
        }
        sha::pair(st, w);
      }
      uint4* dst = nodes + 2 * (node + (2 << p) - (2 << (p - l)) + k);
      dst[0] = make_uint4(st[0], st[1], st[2], st[3]);
      dst[1] = make_uint4(st[4], st[5], st[6], st[7]);
    }
  }
}

// One query's stream through the chain: thread 0 runs its rows from the
// ring, the staging threads fill the ring with them; `g0` is the number of
// rows this launch has chained before them (each staging thread's use
// count of its slot).
__device__ __forceinline__ void chain_stream(const Ring& r, Cursor& cur,
                                             uint32_t st[8], uint32_t chain[8],
                                             const uint4* stream,
                                             const int2* sflags, int nrows,
                                             long long g0) {
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) chain_rows(r, nrows, cur, st, chain);
    __syncwarp();
  } else {
    // rows of this query whose global row number g0 + i maps to my slot
    const int p = threadIdx.x - 32;
    int i = static_cast<int>(((p - g0) % kRing + kRing) % kRing);
    for (; i < nrows; i += kRing) {
      const uint32_t use = static_cast<uint32_t>((g0 + i) / kRing);
      stage_row(r, p, use, stream + 4 * i, sflags[i]);
    }
  }
}

// Queries q_lo .. q_hi - 1: draw, gather and (with chain_drawn) chain
// each.  Query q's values lie at vals + q * vstride, its digests (8 words
// each) at digs + q * dstride.  The cut form (one launch a step of a
// process mesh's query phase, chain_drawn 0) first chains query `absorb`
// (>= 0) from the words an earlier launch gathered and the process group
// summed, then draws and gathers the next query only; an entry whose
// address is 0 (a block another process holds, or replicated data that
// another process writes) reads as zero words, so the sum over the
// processes is each word once.  The one-launch form is absorb -1, queries
// 0 .. nqueries - 1, chain_drawn 1.
__global__ void __launch_bounds__(kThreads, 1)
    query_chain(const uint32_t* __restrict__ chain_in,
                const long long* __restrict__ ptrs,
                const uint4* __restrict__ tmpl,
                const int2* __restrict__ flags,
                const long long* __restrict__ slots,
                const long long* __restrict__ tasks, int nrows, int nslots,
                int nvalues, int ntasks, int max_prune, int wide,
                uint32_t rng, int nqueries,
                uint32_t* __restrict__ chain_out,
                long long* __restrict__ idxs, uint32_t* vals, uint32_t* digs,
                int absorb, int q_lo, int q_hi, int chain_drawn,
                long long vstride, long long dstride) {
  extern __shared__ __align__(128) unsigned char smem[];
  // proof blockIdx.x: its chain, its sources' entries (a fixed stride
  // after proof 0's) and its outputs after proof 0's
  const size_t b = blockIdx.x;
  chain_in += 8 * b;
  chain_out += 8 * b;
  idxs += b * nqueries;
  vals += b * nqueries * vstride;
  digs += b * nqueries * dstride;
  const Ring r = ring_at(smem);
  uint4* stream = reinterpret_cast<uint4*>(smem + kRingBytes + kRingBarBytes);
  int2* sflags = reinterpret_cast<int2*>(stream + 4 * nrows);
  long long* s_idx = reinterpret_cast<long long*>(sflags + nrows);
  uint4* nodes = reinterpret_cast<uint4*>(smem + query_smem_nodes(nrows));
  ring_init(r);
  for (int k = threadIdx.x; k < 4 * nrows; k += kThreads) stream[k] = tmpl[k];
  for (int k = threadIdx.x; k < nrows; k += kThreads) sflags[k] = flags[k];
  mbar_init_fence();
  __syncthreads();

  uint32_t chain[8], st[8];
  Cursor cur{0, 0u};
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) { chain[k] = chain_in[k]; st[k] = 0u; }
  }
  uint32_t* words = reinterpret_cast<uint32_t*>(stream);
  long long chained = 0;  // queries this launch has chained
  if (absorb >= 0) {
    for (int s = threadIdx.x; s < nslots; s += kThreads) {
      uint32_t* dst = words + slots[kSlotColumns * static_cast<size_t>(s) +
                                   kSlotWord];
      if (s < nvalues) {
        hex_words(vals[absorb * vstride + s], dst);
      } else {
        const uint32_t* d = digs + absorb * dstride + (s - nvalues) * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) hex_words(d[k], dst + 2 * k);
      }
    }
    __syncthreads();  // the query's stream is complete
    chain_stream(r, cur, st, chain, stream, sflags, nrows, chained * nrows);
    ++chained;
  }
  for (int q = q_lo; q < q_hi; ++q) {
    if (threadIdx.x == 0) {
      // idx = int(state_hex, 16) mod rng, Horner over the big-endian
      // words; exact in 64 bits because rng < 2^32
      uint64_t m = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) m = ((m << 32) | chain[k]) % rng;
      *s_idx = static_cast<long long>(m);
      idxs[q] = static_cast<long long>(m);
    }
    __syncthreads();  // idx published; the last query's staging is done
    const long long idx = *s_idx;
    if (max_prune > 0) {
      recompute_blocks(tasks, ntasks, max_prune, idx, ptrs, b, wide != 0,
                       nodes);
      __syncthreads();  // every recomputed node is written
    }
    for (int s = threadIdx.x; s < nslots; s += kThreads) {
      const long long* t = slots + kSlotColumns * static_cast<size_t>(s);
      const long long j = ((idx + t[kSlotAdd]) & t[kSlotMask]) ^ t[kSlotXr];
      const long long lane = (j >> t[kSlotShift]) ^ t[kSlotFlip];
      const long long shard = t[kSlotShard];
      const long long pos = t[kSlotBase] + (lane & ((1LL << shard) - 1));
      const long long e = t[kSlotPtab] + (lane >> shard);
      const bool stored = t[kSlotSource] < kTraceSubtree;
      const bool absent = stored && ptrs[2 * e] == 0;
      const unsigned char* src_entry = stored ? entry(ptrs, e, b) : nullptr;
      uint32_t* dst = words + t[kSlotWord];
      if (t[kSlotSource] == kTraceValue || t[kSlotSource] == kFriValue) {
        const uint32_t v =
            absent ? 0u : reinterpret_cast<const uint32_t*>(src_entry)[pos];
        // 8 hex chars of the value's word: after 8 hex zeros of the
        // template for a u32 value, or one half of a 64-bit value
        hex_words(v, dst);
        vals[q * vstride + s] = v;
      } else {
        uint4 lo = make_uint4(0u, 0u, 0u, 0u), hi = lo;
        if (!absent) {
          const uint4* src =
              (src_entry ? reinterpret_cast<const uint4*>(src_entry) : nodes) +
              2 * pos;
          lo = src[0];
          hi = src[1];
        }
        const uint32_t d[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        uint32_t* out = digs + q * dstride + (s - nvalues) * 8;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          hex_words(d[k], dst + 2 * k);
          out[k] = d[k];
        }
      }
    }
    __syncthreads();  // the query's stream is complete
    if (chain_drawn) {
      chain_stream(r, cur, st, chain, stream, sflags, nrows, chained * nrows);
      ++chained;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) chain_out[k] = chain[k];
  }
}

// ---- the dependent-latency probe of K5's bound ------------------------

// One thread times `iters` x 64 steps, each depending on the one before:
// mode 0 a funnel shift (SHF), mode 1 an xor3 (LOP3), mode 2 the round's
// critical path shift -> xor3 -> add (three operations a step); modes 3
// and 4 time 64 independent funnel shifts / xor3s spread over 8 chains,
// the issue interval of one warp.  Inline PTX keeps the compiler from
// folding the chains.  out[0] = clock64 cycles, out[1] keeps the result
// live.
__global__ void dep_latency(long long* out, int mode, int iters, uint32_t y,
                            uint32_t z) {
  if (threadIdx.x != 0 || blockIdx.x != 0) return;
  // per-thread values, so the chains run on the vector pipes (values the
  // compiler sees as uniform would run on the uniform datapath)
  uint32_t x = y ^ z ^ threadIdx.x;
  uint32_t v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = x + k;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
    if (mode == 0) {
#pragma unroll
      for (int k = 0; k < 64; ++k)
        asm volatile("shf.r.wrap.b32 %0, %0, %0, 7;" : "+r"(x));
    } else if (mode == 1) {
#pragma unroll
      for (int k = 0; k < 64; ++k)
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                     : "+r"(x) : "r"(y), "r"(z));
    } else if (mode == 2) {
#pragma unroll
      for (int k = 0; k < 64; ++k)
        asm volatile(
            "shf.r.wrap.b32 %0, %0, %0, 6;\n\t"
            "lop3.b32 %0, %0, %1, %2, 0x96;\n\t"
            "add.u32 %0, %0, %1;"
            : "+r"(x) : "r"(y), "r"(z));
    } else if (mode == 3) {
#pragma unroll
      for (int k = 0; k < 64; ++k)
        asm volatile("shf.r.wrap.b32 %0, %0, %0, 7;" : "+r"(v[k & 7]));
    } else {
#pragma unroll
      for (int k = 0; k < 64; ++k)
        asm volatile("lop3.b32 %0, %0, %1, %2, 0x96;"
                     : "+r"(v[k & 7]) : "r"(y), "r"(z));
    }
  }
  const long long t1 = clock64();
#pragma unroll
  for (int k = 0; k < 8; ++k) x ^= v[k];
  out[0] = t1 - t0;
  out[1] = x;
}

}  // namespace

// Let both kernels take up to kMaxSmem of dynamic shared memory, once per
// device (bit d of `allowed`); a refused attribute is returned as the
// launch's error.
static cudaError_t allow_smem() {
  static unsigned long long allowed = 0;
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess || (d < 64 && (allowed >> d) & 1ull)) return err;
  err = cudaFuncSetAttribute(
      sha_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        query_chain, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err == cudaSuccess && d < 64) allowed |= 1ull << d;
  return err;
}

// stream: (nblocks, 16) words; flags: (nblocks, 2) int32 (first, last);
// chain_in / chain_out: 8 words each; for `batch` chains (one block
// each), chain b's rows `stream_stride` and its flags `flag_stride` rows
// after chain 0's (a stride of 0 shares them), its states 8 words after
// chain b - 1's.
extern "C" int stark_sha_chain(const void* stream, const void* flags,
                               const void* chain_in, void* chain_out,
                               int nblocks, long long stream_stride,
                               long long flag_stride, int batch, void* s) {
  if (nblocks < 0 || batch < 0 || stream_stride < 0 || flag_stride < 0)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (batch > 0)
    sha_chain<<<batch, kThreads, kChainSmem, (cudaStream_t)s>>>(
        (const uint4*)stream, (const int2*)flags, (const uint32_t*)chain_in,
        (uint32_t*)chain_out, nblocks, stream_stride, flag_stride);
  return (int)cudaGetLastError();
}

// The whole query phase: nqueries queries of nrows stream rows each.
// ptrs: (entries, 2) int64 source table, each entry's address and its
// per-proof stride in bytes (values: u32 words; digests: (rows, 8)
// words, the trees' stored levels); template: (nrows, 16) words; flags:
// (nrows, 2); slots: (nslots, kSlotColumns) int64 (values first, then
// digests); tasks: (ntasks, kTaskColumns) int64, whose nodes fill `nodes`
// digest rows, the deepest at max_prune; wide: the values are 64-bit limb
// planes.  Out: chain_out (8,), idxs (nqueries,) int64, vals and digs:
// query q's nvalues words at vals + q * vstride and its nslots - nvalues
// digests of 8 words at digs + q * dstride.  The launch runs queries
// q_lo .. q_hi - 1, chained when chain_drawn, after chaining query
// `absorb` from vals / digs when absorb >= 0 (the cut form, query_chain
// above).  For `batch` proofs of one plan, one block each, proof b's
// chain state and sources lie a fixed stride after proof 0's, its
// outputs right after proof b - 1's.
extern "C" int stark_query_chain(
    const void* chain_in, const void* ptrs, const void* tmpl,
    const void* flags, const void* slots, const void* tasks, int nrows,
    int nslots, int nvalues, int ntasks, int max_prune, int nodes, int wide,
    unsigned rng, int nqueries, void* chain_out, void* idxs, void* vals,
    void* digs, int absorb, int q_lo, int q_hi, int chain_drawn,
    long long vstride, long long dstride, int batch, void* s) {
  if (nodes < 0 || max_prune < 0 || (max_prune > 0) != (ntasks > 0) ||
      batch < 0 || absorb >= nqueries || q_lo < 0 || q_hi > nqueries ||
      vstride < 0 || dstride < 0)
    return (int)cudaErrorInvalidValue;
  const int bytes = query_smem(nrows, nodes);
  if (bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (batch > 0)
    query_chain<<<batch, kThreads, bytes, (cudaStream_t)s>>>(
        (const uint32_t*)chain_in, (const long long*)ptrs,
        (const uint4*)tmpl, (const int2*)flags, (const long long*)slots,
        (const long long*)tasks, nrows, nslots, nvalues, ntasks, max_prune,
        wide, rng, nqueries, (uint32_t*)chain_out, (long long*)idxs,
        (uint32_t*)vals, (uint32_t*)digs, absorb, q_lo, q_hi, chain_drawn,
        vstride, dstride);
  return (int)cudaGetLastError();
}

// Let the current device's kernels read `peer`'s memory (K5's query
// form over a mesh of distinct cards); enabling it twice is not an
// error.
extern "C" int stark_enable_peer(int peer) {
  const cudaError_t err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // reset the last-error state the call set
    return 0;
  }
  return (int)err;
}

// The most stream rows a query of stark_query_chain may have beside
// `nodes` recomputed digest rows.
extern "C" int stark_query_chain_max_rows(int nodes) {
  return (kMaxSmem - nodes * 32 - query_smem_nodes(0) - 15) / (64 + 8);
}

extern "C" int stark_dep_latency(void* out, int mode, int iters, void* s) {
  dep_latency<<<1, 32, 0, (cudaStream_t)s>>>((long long*)out, mode, iters,
                                             0x9E3779B9u, 0x7F4A7C15u);
  return (int)cudaGetLastError();
}
