// The micro-probes for Hopper (sm_90a), built into the "probes" library
// (kernels/build.py): one kernel family per TPU probe of experiments/, one
// plain-C entry per probe file, the body chosen by an int argument.
//
// The TPU probes asked what a Pallas body costs on one TensorCore: a
// dependent VMEM load, a lane extracted from a row, a gather, an async copy,
// a loop body's features, the element-wise rate per type. Their ports put
// the same questions to the H100, in two launch shapes: one copy (the TPU's
// one program: ns per iteration of a single dependent chain) and as many
// independent copies as fill every SM at the kernel's occupancy (what the
// card does when latency is hidden across warps: ns per iteration per SM).
// Every copy computes the same function and writes its own output.
//
// What bounds them here: the correctness probes (mosaic, mosaic2) are one
// small launch each, bound by the launch's own cost: a few microseconds
// against a bound of nanoseconds (mosaic's bodies are timed in turns as
// CUDA-graph replays, probe_mosaic --against). The chains (chain, body,
// dyn_cost, gather's chain) are bound by the latency of one dependent load
// or barrier per step with one copy, and by L1/shared bandwidth or issue
// slots with the card full. mosaic3 and vpu are bound by the CUDA cores'
// issue rate.
//
// Numbers stay bit-exact against the plain torch versions: every float sum
// is taken in the JAX body's order, and the library is built with
// -fmad=false so no multiply is contracted into an add.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kInfv = 3.4e38f;   // probe_mosaic2's INFV

// Python's floor modulo, which jnp's % follows
__device__ __forceinline__ int floor_mod(int a, int b) {
  const int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int o = 16; o; o >>= 1) v = fminf(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_min(int v) {
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(~0u, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

__device__ __forceinline__ float fold(float a, float b, bool) {
  return fminf(a, b);
}
__device__ __forceinline__ int fold(int a, int b, bool sum) {
  return sum ? a + b : min(a, b);
}

// The minimum (or sum) over the block, returned to every thread: warp
// shuffles, then each thread folds the warps' results from shared memory.
// Called by every thread of the block; sh holds 32 values.
template <typename T>
__device__ T block_reduce(T v, T* sh, bool sum) {
  v = sum ? (T)warp_sum((int)v) : warp_min(v);
  __syncthreads();                       // sh is free from the last call
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = sh[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) r = fold(r, sh[w], sum);
  return r;
}

__device__ __forceinline__ float block_min(float v, float* sh) {
  return block_reduce(v, sh, false);
}
__device__ __forceinline__ int block_min(int v, int* sh) {
  return block_reduce(v, sh, false);
}
__device__ __forceinline__ int block_sum(int v, int* sh) {
  return block_reduce(v, sh, true);
}

// ---------------------------------------------------------------------------
// probe_mosaic: experiments/probe_mosaic.py:31-103, run at :14-24 on the
// (16, 128) input arange/7. Correctness probes of the pair kernel's Mosaic
// constructs; each is one launch, timed by CUDA-graph replays against the
// launch's own cost. dot has a kernel of its own (mosaic_dot_kernel); the
// other six bodies are one block of 128 threads, thread j owning lane j of
// every row. Scratch (the TPU's VMEM and SMEM) is shared memory;
// pltpu.roll is jnp.roll (lane j takes lane (j - shift) mod 128), done
// through shared memory.
enum { kDot, kDynRoll, kDynStore, kDynStoreOdd, kSmemDyn, kNested,
       kArgminLane };

// k_dot :31-43: out[r, j] is the 128-term sum over k of lhs[r, k] *
// sel[k, j] in k order, lhs[r, k] = x[0, k] for k in [8r, 8r + 8) and +0.0
// elsewhere, sel[k, j] = (k % 8 == j / 16). Outside [8r, 8r + 8) each term
// is +0.0 * sel = +0.0, and adding +0.0 leaves the running sum as it is:
// the sum starts at +0.0 and is never -0.0 (a sum is -0.0 only where both
// addends are), and NaN stays NaN. So the 8 terms over k = 8r..8r+7, in
// order, give the same bits for every input, inf, NaN, -0.0 and
// subnormals included. One output a thread, 2,048 threads as two blocks
// of 1,024: on an H100, in turns, 0.52x the time of one block of 128
// threads with 16 outputs each and 0.11x the 128-term loop's.
__global__ void __launch_bounds__(1024) mosaic_dot_kernel(
    const float* __restrict__ x, float* __restrict__ out) {
  const int g = blockIdx.x * 1024 + threadIdx.x;
  // row r, lane j; sel[k, j] is 1 where k % 8 == one
  const int r = g >> 7, j = g & 127, one = j >> 4;
  float acc = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    acc = acc + x[8 * r + i] * (i == one ? 1.f : 0.f);
  out[g] = acc;
}

__global__ void __launch_bounds__(128) mosaic_kernel(
    int body, const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float scr[34 * 128];
  __shared__ int sm[34];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int j = threadIdx.x;
  const int* xi = reinterpret_cast<const int*>(x);
  switch (body) {
    case kDynRoll: {           // k_dynroll :46-50
      int* sh = reinterpret_cast<int*>(scr);
      const int s = floor_mod(xi[0], 8) + 1;
      for (int e = j; e < 16 * 128; e += 128) sh[e] = xi[e];
      __syncthreads();
      for (int r = 0; r < 16; ++r)
        out[r * 128 + j] = __int_as_float(sh[r * 128 + ((j - s) & 127)]);
      break;
    }
    case kDynStore:            // k_dynstore :53-56, scratch (8, 128)
    case kDynStoreOdd: {       // k_dynstore_odd :59-63, scratch (34, 128)
      const int idx = floor_mod(xi[1], body == kDynStore ? 8 : 34);
      scr[idx * 128 + j] = x[j] * 2.f;
      __syncthreads();
      for (int r = 0; r < 16; ++r) out[r * 128 + j] = scr[idx * 128 + j];
      break;
    }
    case kSmemDyn: {           // k_smem_dyn :66-69, 34 int32 of SMEM
      const int idx = floor_mod(xi[1], 34);
      if (j == 0) sm[idx] = 7;
      __syncthreads();
      for (int r = 0; r < 16; ++r)
        out[r * 128 + j] = x[r * 128 + j] + (float)sm[idx];
      break;
    }
    case kNested:              // k_nested :72-95
      for (int r = 0; r < 16; ++r) {
        float acc = 0.f;
        for (int i = 0; i < 4; ++i) {
          if (i % 2 == 0) {
            for (int s = 0; s < 3; ++s) acc = acc + x[r * 128 + j];
          } else {
            acc = acc + 1.f;
          }
        }
        out[r * 128 + j] = acc;
      }
      break;
    case kArgminLane: {        // k_argmin_lane :98-103, the first minimum
      // jnp.min propagates a NaN, and no lane is <= NaN: the lane is then
      // 128. block_min's fminf skips a NaN, so the NaN is looked for apart.
      const float kr = x[j];
      const bool nan = __syncthreads_or(kr != kr);
      const float minv = block_min(kr, redf);
      const int lane = block_min(kr <= minv ? j : 128, redi);
      const float v = (float)(nan ? 128 : lane);
      for (int r = 0; r < 16; ++r) out[r * 128 + j] = v;
      break;
    }
  }
}

// ---------------------------------------------------------------------------
// probe_mosaic2: experiments/probe_mosaic2.py:30-174, the same input and
// block shape. k_stack_machine (:75-135) is pallas_pair's skeleton: an
// argmin pop over a stack row, a code read through a roll, a conditional
// push. It maps as K6 does: thread 0 keeps the scalar state (the SMEM
// counts) in shared memory, every thread owns one lane of the stack rows,
// and block barriers order the pop, the reductions and the push. acc is a
// (16, 128) value that every branch changes by one scalar, so each thread
// keeps one float for its lane's 16 rows.
enum { kDotInLoop, kDynRollInLoop, kDynStoreInWhile, kStackMachine,
       kDynStore8InWhile };

__global__ void __launch_bounds__(128) mosaic2_kernel(
    int body, const float* __restrict__ x, float* __restrict__ out) {
  __shared__ float scr[64 * 128];
  __shared__ int nst[8 * 128];
  __shared__ int sm[8];
  __shared__ int roll[128];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int j = threadIdx.x;
  const int* xi = reinterpret_cast<const int*>(x);
  float acc = 0.f;
  switch (body) {
    case kDotInLoop: {         // :30-40, 50 products of (16,128)x(128,128)
      float rows[16];
      for (int r = 0; r < 16; ++r) rows[r] = 0.f;
      for (int it = 0; it < 50; ++it) {
        __syncthreads();
        scr[j] = x[j] + rows[0];
        __syncthreads();
        for (int r = 0; r < 16; ++r) {
          float dot = 0.f;
          for (int k = 0; k < 128; ++k)
            dot = dot + scr[k] * ((k % 8 == j / 16) ? 1.f : 0.f);
          rows[r] = rows[r] + dot * 1e-6f;
        }
      }
      for (int r = 0; r < 16; ++r) out[r * 128 + j] = rows[r];
      return;
    }
    case kDynRollInLoop: {     // :43-49
      int* sh = reinterpret_cast<int*>(scr);
      float rows[16];
      for (int r = 0; r < 16; ++r) rows[r] = 0.f;
      for (int e = j; e < 16 * 128; e += 128) sh[e] = xi[e];
      __syncthreads();
      for (int it = 0; it < 50; ++it) {
        const int s = it % 8 + 1;
        for (int r = 0; r < 16; ++r)
          rows[r] = rows[r]
                    + __int_as_float(sh[r * 128 + ((j - s) & 127)]) * 0.f;
      }
      for (int r = 0; r < 16; ++r) out[r * 128 + j] = rows[r];
      return;
    }
    case kDynStoreInWhile:     // :52-72, one row per entry
    case kDynStore8InWhile: {  // :153-174, (8, 128) per entry
      const int h = body == kDynStoreInWhile ? 1 : 8;
      for (int r = 0; r < h; ++r) {
        scr[r * 128 + j] = x[j];
        scr[(h + r) * 128 + j] = x[128 + j];
      }
      if (j == 0) { sm[0] = 2; sm[1] = 3; }
      int sp = 2;
      __syncthreads();
      while (sp > 0) {
        const float row = scr[(sp - 1) * h * 128 + j];
        __syncthreads();
        if (j == 0) sm[sp - 1] = sm[sp - 1] - 1;
        __syncthreads();
        const int rem = sm[sp - 1];
        for (int r = 0; r < h; ++r)
          scr[((sp - 1) * h + r) * 128 + j] =
              scr[((sp - 1) * h + r) * 128 + j] + 1.f;
        acc = acc + row;
        sp = rem > 0 ? sp : sp - 1;
        __syncthreads();
      }
      break;
    }
    case kStackMachine: {      // :75-135
      float* kst = scr;                  // (8, 128) keys
      const int lane_j = j;
      kst[j] = j == 0 ? 0.f : kInfv;
      nst[j] = j == 120 ? 1 : 0;
      if (j == 0) sm[0] = 1;
      int sp = 1, it = 0;
      __syncthreads();
      while (sp > 0 && it < 64) {
        const float kr = kst[(sp - 1) * 128 + j];
        roll[j] = nst[(sp - 1) * 128 + j];
        const float minv = block_min(kr, redf);
        const int lane = block_min(kr <= minv ? lane_j : 128, redi);
        const int cslot = lane / 16;
        // roll(nri, 8 - cslot)[0, 0]: the lane that lands on lane 0
        const int code = roll[floor_mod(-(8 - cslot), 128)];
        const int rem = sm[sp - 1] - 1;
        __syncthreads();
        kst[(sp - 1) * 128 + j] = j == lane ? kInfv : kr;
        if (j == 0) sm[sp - 1] = rem;
        sp = rem > 0 ? sp : sp - 1;
        if (code > 0) {                  // do_push :102-115
          const float krow = ((j % 16 == 0) && (j < 32 * code))
                                 ? x[0] * 0.f + (float)j : kInfv;
          const int nhit = block_sum(krow < kInfv ? 1 : 0, redi);
          const bool push = nhit > 0 && code < 3;
          const int idx = push ? sp : 7;
          kst[idx * 128 + j] = krow;
          nst[idx * 128 + j] = j == 120 ? code + 1
                               : (j == 121 ? -(code + 1) : 0);
          if (j == 0) sm[idx] = nhit;
          acc = acc + 1.f;
          sp = push ? sp + 1 : sp;
        } else {                         // do_leaf :117-127
          bool done = false;
          int cc = code, k = 0;
          while (!done && k < 4) {
            done = cc <= -2;
            cc -= 1;
            k += 1;
            acc = acc + 2.f;
          }
        }
        it += 1;
        __syncthreads();
      }
      break;
    }
  }
  for (int r = 0; r < 16; ++r) out[r * 128 + j] = acc;
}


// ---------------------------------------------------------------------------
// probe_gather: experiments/probe_gather.py, run at :28-35. A take_along_axis
// per element: element (r, j) reads word idx of its row r (axis 1) or row
// idx of its column j (axis 0).
//   kTake (:38-57 f32, :60-75 int32): any (rows, 128), a grid over the card
//     (gather_take_kernel below).
//   kChain (:92-108): K = 2048 dependent lane gathers of an int32 (8, 128)
//     table, idx = (tbl[r, idx] + 1) & 127.
//   kFields (:113-130): a 56-field (8, 128) f32 block, 256 iterations; each
//     sums its 56 gathers in field order and moves idx by the sum.
//   kPages (:133-162): P = 1, 2, 4, 8 pages of 28 fields; the TPU selects a
//     page with a chain of P where()s, the card indexes the page directly
//     (the same value: hi < P always).
// The timed bodies ask the card: does a ray fetch its node's fields from a
// page held in shared memory faster than from global memory through __ldg,
// as K1 does? With smem=1 the table goes in shared memory (56 x 4 KB = 224
// KB and 2 pages x 28 x 4 KB = 224 KB fit the 227 KB a block may have; 4
// and 8 pages do not, and the wrapper refuses smem there); with smem=0
// every gather is an __ldg of the caller's field-major table.
//
// What bounds them: the fields and pages bodies add each element's F = 56
// or 28 gathered fields in field order, one FADD a field (-fmad=false),
// and the card issues one FADD a lane and cycle; every load and address
// instruction takes an issue slot from them, and each load is one or more
// shared-memory (or L1) wavefronts. The chain is one dependent load a step
// per element: its latency with one copy, the loads' wavefronts with the
// card full. The design:
// - a copy is kThreads threads (256, 512 or 1,024 by body), each holding
//   1024 / kThreads elements of one column j, rows r0, r0 + kThreads /
//   128, ... (r0 = t >> 7), so a thread carries independent chains and a
//   warp's lanes share their rows (the JAX inputs start every lane of a
//   row at one index, so its gathers are broadcasts);
// - the shared copy is word-major: word (page, row, w)'s F fields are
//   contiguous and 16-byte aligned (F x 4 bytes is 224 or 112), so one
//   16-byte load brings four fields, as K7's and K4's row loads; the
//   staging loop transposes the caller's field-major table (each thread
//   reads a word's fields, its warp's lanes neighbouring words);
// - the global variants have no 16-byte form (the caller's fields are 4 KB
//   apart): their loads go in batches of kGatherBatch fields for all of a
//   thread's elements ahead of the adds (asking for the most L1 changed
//   nothing);
// - the chain's step loop is unrolled kGatherUnroll times.
// Every element still adds its fields in field order and converts with
// the same truncation, so every output is the plain version's bit for bit.
enum { kTake, kChain, kFields, kPages };
constexpr int kChainSteps = 2048, kFieldIters = 256, kFields56 = 56,
              kPageFields = 28;
// threads a copy (kThreads below) of the chain in shared and in global
// memory and of the other shared-memory and global bodies, each the fastest
// of 256, 512 and 1,024 (PERF.md, section 6); a thread holds 1024 /
// kThreads elements
constexpr int kGatherThreadsChainShared = 256, kGatherThreadsChainGlobal = 1024,
              kGatherThreadsShared = 512, kGatherThreadsGlobal = 1024;
constexpr int kGatherBatch = 7, kGatherUnroll = 8;

// kTake: out[e] = tbl[r, idx[e]] (axis 1) or tbl[idx[e], j] (axis 0) over
// a (rows, 128) table of 32-bit words, jnp.take_along_axis and
// torch.gather(tbl, axis, idx). Bound by bytes (table, indices and output
// once each), and below a few thousand rows by the launch itself. The TPU
// ran it as one program; here one thread takes a 16-byte group of four
// elements of one row (rows * 128 is a multiple of 4), kTakeThreads
// threads a block and rows / 4 blocks, so the grid spreads over every SM
// (128 blocks at 512 rows) and no thread waits on a series of loads. A
// thread's index load and output store are one coalesced 16-byte access
// each; its four table loads are independent __ldg's. Axis 1: a warp's
// 128 gathers fall in one 512-byte row, which L1 holds after its first
// touch. Axis 0: each lane reads a word of four other rows, a 32-byte
// sector for each 4-byte word, from a table that sits in L2 as far as it
// fits (the access torch.gather makes too).
constexpr int kTakeThreads = 128;

template <int kAxis>
__global__ void __launch_bounds__(kTakeThreads) gather_take_kernel(
    const int* __restrict__ tbl, const int4* __restrict__ idx,
    int4* __restrict__ out, int groups) {
  const int g = blockIdx.x * kTakeThreads + threadIdx.x;
  if (g >= groups) return;
  const int4 i = __ldg(idx + g);
  const int e = g * 4;
  int4 o;
  if (kAxis == 1) {
    const int* row = tbl + (e & ~127);
    o.x = __ldg(row + i.x);
    o.y = __ldg(row + i.y);
    o.z = __ldg(row + i.z);
    o.w = __ldg(row + i.w);
  } else {
    const int* col = tbl + (e & 127);
    o.x = __ldg(col + i.x * 128);
    o.y = __ldg(col + i.y * 128 + 1);
    o.z = __ldg(col + i.z * 128 + 2);
    o.w = __ldg(col + i.w * 128 + 3);
  }
  out[g] = o;
}

template <int kBody, bool kSmem, int kThreads>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const float* __restrict__ tbl, const int* __restrict__ idx0,
    int* __restrict__ out, int pages) {
  constexpr int kE = 1024 / kThreads, kStep = kThreads / 128;
  static_assert(kStep * kE == 8, "a copy's 8 rows, kE a thread");
  extern __shared__ float4 shm4[];
  const int t = threadIdx.x, j = t & 127, r0 = t >> 7;
  int idx[kE];
#pragma unroll
  for (int e = 0; e < kE; ++e) idx[e] = idx0[(r0 + kStep * e) * 128 + j];
  if (kBody == kChain) {
    if (kSmem) {
      const float4* src = reinterpret_cast<const float4*>(tbl);
      for (int w = t; w < 256; w += kThreads) shm4[w] = src[w];
      __syncthreads();
    }
    const int* T = reinterpret_cast<const int*>(
        kSmem ? reinterpret_cast<const float*>(shm4) : tbl);
    for (int k = 0; k < kChainSteps; k += kGatherUnroll) {
#pragma unroll
      for (int u = 0; u < kGatherUnroll; ++u) {
#pragma unroll
        for (int e = 0; e < kE; ++e) {
          const int* w = T + (r0 + kStep * e) * 128 + idx[e];
          idx[e] = ((kSmem ? *w : __ldg(w)) + 1) & 127;
        }
      }
    }
  } else {
    constexpr int F = kBody == kFields ? kFields56 : kPageFields;
    constexpr int Q = F / 4;               // 16-byte groups of a word
    const int P = kBody == kFields ? 1 : pages;
    if (kSmem) {
      // word (p, r, w) = wd = (p * 8 + r) * 128 + w at shm4[wd * Q]; its
      // field f at tbl[(f * P + p) * 1024 + (wd & 1023)]
      for (int wd = t; wd < P * 1024; wd += kThreads) {
        const float* src = tbl + (wd >> 10) * 1024 + (wd & 1023);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          float4 v;
          v.x = __ldg(src + (4 * q) * P * 1024);
          v.y = __ldg(src + (4 * q + 1) * P * 1024);
          v.z = __ldg(src + (4 * q + 2) * P * 1024);
          v.w = __ldg(src + (4 * q + 3) * P * 1024);
          shm4[wd * Q + q] = v;
        }
      }
      __syncthreads();
    }
    const int mask = P * 128 - 1;
    for (int it = 0; it < kFieldIters; ++it) {
      float acc[kE];
#pragma unroll
      for (int e = 0; e < kE; ++e) acc[e] = 0.f;
      if (kSmem) {
        const float4* w[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          w[e] = shm4 + (((idx[e] >> 7) * 8 + r0 + kStep * e) * 128
                         + (idx[e] & 127)) * Q;
#pragma unroll
        for (int q = 0; q < Q; ++q) {
#pragma unroll
          for (int e = 0; e < kE; ++e) {
            const float4 v = w[e][q];
            acc[e] = acc[e] + v.x;
            acc[e] = acc[e] + v.y;
            acc[e] = acc[e] + v.z;
            acc[e] = acc[e] + v.w;
          }
        }
      } else {
        // field f of element e at w[e] + f * P * 1024
        const float* w[kE];
#pragma unroll
        for (int e = 0; e < kE; ++e)
          w[e] = tbl + ((idx[e] >> 7) * 8 + r0 + kStep * e) * 128
                 + (idx[e] & 127);
#pragma unroll
        for (int f0 = 0; f0 < F; f0 += kGatherBatch) {
          float v[kE][kGatherBatch];
#pragma unroll
          for (int e = 0; e < kE; ++e) {
#pragma unroll
            for (int b = 0; b < kGatherBatch; ++b)
              v[e][b] = __ldg(w[e] + (f0 + b) * P * 1024);
          }
#pragma unroll
          for (int b = 0; b < kGatherBatch; ++b) {
#pragma unroll
            for (int e = 0; e < kE; ++e) acc[e] = acc[e] + v[e][b];
          }
        }
      }
#pragma unroll
      for (int e = 0; e < kE; ++e) idx[e] = (idx[e] + (int)acc[e]) & mask;
    }
  }
#pragma unroll
  for (int e = 0; e < kE; ++e)
    out[blockIdx.x * 1024 + (r0 + kStep * e) * 128 + j] = idx[e];
}

// ---------------------------------------------------------------------------
// probe_mosaic3: experiments/probe_mosaic3.py, _kernel :28-51 (run :54-71)
// and _kernel2 :78-98 (run2 :101-124). N = 4096 iterations add K = 24 words
// of one table row (lanes j * 5 % 128) to a (64, 128) accumulator; the row
// is (i * 7 + 3) % 1024, or, in the dep- modes, the int32 bits of lane 0 of
// the last row (a pop's chase).
//   extract: each thread loads each word itself (K1's per-field __ldg);
//   slice: each warp loads the row once with 16-byte loads (4 words a lane)
//     and passes the words on with __shfl_sync (K4's row_loads).
// The float adds are the work: with -fmad=false the card issues one FADD
// per lane and cycle, and every load, shuffle or loop instruction takes an
// issue slot from them. So a copy is one block of kM3Threads = 256
// threads, each holding kM3Vals = 32 of the 8,192 values: every word loaded
// or shuffled feeds 32 adds. The next row's loads are issued before this
// row's adds: its index is known ahead (the first three modes) or is word 0
// of this row (the dep- modes, whose chain is that one load an iteration).
// Each value takes its adds in the JAX order, word 0 to 23, iteration by
// iteration. Bound with one copy or the card full: the FADD issue rate.
enum { kNone, kExtract, kSlice, kDepExtract, kDepSlice };
constexpr int kM3Iters = 4096, kM3Words = 24, kM3Rows = 1024;
constexpr int kM3Vals = 32, kM3Threads = 64 * 128 / kM3Vals;

// One row as a thread holds it between its loads and its adds: extract's
// 24 words, each loaded by the thread; slice's 16 bytes, lane l holding
// words 4l to 4l + 3, from which word(j) shuffles word j to every lane.
template <bool kSliced>
struct M3Row {
  float w[kM3Words];
  __device__ __forceinline__ void load(const float* row) {
#pragma unroll
    for (int j = 0; j < kM3Words; ++j) w[j] = __ldg(row + j * 5 % 128);
  }
  __device__ __forceinline__ float word(int j) const { return w[j]; }
};

template <>
struct M3Row<true> {
  float4 q;
  __device__ __forceinline__ void load(const float* row) {
    q = __ldg(reinterpret_cast<const float4*>(row) + (threadIdx.x & 31));
  }
  __device__ __forceinline__ float word(int j) const {
    const int lane = j * 5 % 128;
    const float c = (lane & 3) == 0 ? q.x : (lane & 3) == 1 ? q.y
                    : (lane & 3) == 2 ? q.z : q.w;
    return __shfl_sync(~0u, c, lane >> 2);
  }
};

template <int kMode>
__global__ void __launch_bounds__(kM3Threads) mosaic3_kernel(
    const float* __restrict__ tab, float* __restrict__ out) {
  constexpr bool kDep = kMode == kDepExtract || kMode == kDepSlice;
  const int t = threadIdx.x;
  // a start of 0 that the compilers cannot see (tab is never null): from a
  // known start, nvcc and ptxas fold mode none's 4096 adds of 1.0 into one
  // constant, even when the add is written as inline PTX
  const float zero = tab == nullptr ? 1.f : 0.f;
  float acc[kM3Vals];
#pragma unroll
  for (int k = 0; k < kM3Vals; ++k) acc[k] = zero;
  if (kMode == kNone) {
    for (int i = 0; i < kM3Iters; ++i) {
#pragma unroll
      for (int k = 0; k < kM3Vals; ++k) acc[k] = acc[k] + 1.f;
    }
  } else {
    M3Row<kMode == kSlice || kMode == kDepSlice> cur, nxt;
    cur.load(tab + (kDep ? 0 : 3) * 128);
    for (int i = 0; i < kM3Iters; ++i) {
      const float w0 = cur.word(0);
      if (i + 1 < kM3Iters)
        nxt.load(tab + (kDep ? __float_as_int(w0)
                             : ((i + 1) * 7 + 3) % kM3Rows) * 128);
#pragma unroll
      for (int j = 0; j < kM3Words; ++j) {
        const float v = j == 0 ? w0 : cur.word(j);
#pragma unroll
        for (int k = 0; k < kM3Vals; ++k) acc[k] = acc[k] + v;
      }
      cur = nxt;
    }
  }
#pragma unroll
  for (int k = 0; k < kM3Vals; ++k)
    out[blockIdx.x * 8192 + k * kM3Threads + t] = acc[k];
}

// ---------------------------------------------------------------------------
// probe_chain: experiments/probe_chain.py, _kernel :36-70 (run :73-96).
// S = 1, 2, 4 chains interleaved in one loop of N = 2048 steps; a step loads
// row idx of a (1024, 128) table and takes the int32 bits of its lane 0 as
// the next idx (a permutation), K1's pop-to-load chain. The chase touches
// one 128-byte line per row, 128 KB in all.
//   chase, chase+smem: one thread per copy (the TPU's scalar chain).
//     chase+smem stores each step's idx to a stack and reads it back: a
//     per-thread local-memory array indexed by a running slot, as K1's
//     stack (kChaseLocal), or the thread's words of a shared array
//     (kChaseShared, the TPU's SMEM), word s of thread x at s *
//     kScalarBlock + x, so a warp's 32 words fall in 32 banks.
//   chase+vec: one block of kVecThreads = 256 threads per copy: the (64,
//     128) vector stage of each step (32 values a thread, column t & 127)
//     and its minimum over the block feed the next idx: K5's
//     block-synchronous pop. probe_body's step (stage_value, put_warp_min,
//     block_min_of, shared with body_kernel): one barrier a step, the warps'
//     minima in slots double-buffered by the step's parity, and the row's
//     lane 0 (thread 0's load) passed on the same way. `aux` gets the
//     fold of every step's minimum (FNV-1a over its bits, stream by
//     stream), which the output does not read.
// Bound with one copy: the latency of a load (plus a local or shared store
// and load, or the block's reduction) per step; with the card full, the
// rate at which L1 serves the warps' dependent loads (about 0.55 to 0.65
// a cycle and SM, PERF.md section 6: unrolling the steps or loading
// through ld.global.ca moved neither shape).
enum { kChase, kChaseLocal, kChaseShared, kChaseVec };
constexpr int kChainN = 2048, kChainNN = 1024, kScalarBlock = 128,
              kVecThreads = 256;

template <int kMode, int kS>
__global__ void __launch_bounds__(kScalarBlock) chain_scalar_kernel(
    const float* __restrict__ tab, int* __restrict__ out, int copies) {
  __shared__ volatile int shstack[4 * kScalarBlock];
  volatile int stack[4];
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= copies) return;
  int idx[kS];
  for (int s = 0; s < kS; ++s) idx[s] = s * 37 % kChainNN;
  for (int i = 0; i < kChainN; ++i) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      int nxt = __float_as_int(__ldg(tab + idx[s] * 128));
      if (kMode == kChaseLocal) {
        const int slot = (i + s) & 3;     // a dynamic index, as K1's stack
        stack[slot] = nxt;
        nxt = stack[slot];
      } else if (kMode == kChaseShared) {
        shstack[s * kScalarBlock + threadIdx.x] = nxt;
        nxt = shstack[s * kScalarBlock + threadIdx.x];
      }
      idx[s] = nxt;
    }
  }
  int acc = 0;
  for (int s = 0; s < kS; ++s) acc = acc + idx[s];
  out[c] = acc;
}

// One value of the vector stage (probe_chain.py :45-46, probe_body.py's):
// v = row * 1.000001, min(v * 1.5, v + last).
__device__ __forceinline__ float stage_value(float rj, float last) {
  const float v = rj * 1.000001f;
  return fminf(v * 1.5f, v + last);
}

// Warp w's minimum of m to its slot of `part` (its lane 0 writes it).
__device__ __forceinline__ void put_warp_min(float m, float* part, int lane,
                                             int w) {
  m = warp_min(m);
  if (lane == 0) part[w] = m;
}

// After the barrier: the minimum of the kW warps' slots, in every thread
// (a lane reads one slot, log2(kW) shuffles fold them). A float minimum is
// exact in any order (the tables hold no NaN and make no -0), so every
// order gives the plain version's bits.
template <int kW>
__device__ __forceinline__ float block_min_of(const float* part, int lane) {
  float m = part[lane & (kW - 1)];
#pragma unroll
  for (int o = kW / 2; o; o >>= 1) m = fminf(m, __shfl_xor_sync(~0u, m, o));
  return m;
}

template <int kS>
__global__ void __launch_bounds__(kVecThreads) chain_vec_kernel(
    const float* __restrict__ tab, int* __restrict__ out,
    int* __restrict__ aux) {
  constexpr int kW = kVecThreads / 32, kV = 64 * 128 / kVecThreads;
  __shared__ float part[2][kS][kW];     // each warp's minimum
  __shared__ int word[2][kS];           // the row's lane 0
  const int t = threadIdx.x, j = t & 127, lane = t & 31, w = t >> 5;
  int idx[kS];
  float acc[kS][kV];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    idx[s] = s * 37 % kChainNN;
#pragma unroll
    for (int k = 0; k < kV; ++k) acc[s][k] = 0.f;
  }
  unsigned h = 2166136261u;
  for (int i = 0; i < kChainN; ++i) {
    const int b = i & 1;               // every step takes the barrier
    float rj[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s) rj[s] = __ldg(tab + idx[s] * 128 + j);
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      float m = kInfv;
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float v = stage_value(rj[s], acc[s][k]);
        acc[s][k] = v;
        m = fminf(m, v);
      }
      put_warp_min(m, part[b][s], lane, w);
      if (t == 0) word[b][s] = __float_as_int(rj[s]);
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      const float m = block_min_of<kW>(part[b][s], lane);
      idx[s] = word[b][s] + (m > 1e30f ? 1 : 0);
      h = (h ^ (unsigned)__float_as_int(m)) * 16777619u;
    }
  }
  if (t == 0) {
    int a = 0;
#pragma unroll
    for (int s = 0; s < kS; ++s) a = a + idx[s];
    out[blockIdx.x] = a;
    if (aux) aux[blockIdx.x] = (int)h;
  }
}


// ---------------------------------------------------------------------------
// probe_body: experiments/probe_body.py, _kernel :33-95 (run :98-123). The
// loop body of the packet kernel, feature by feature, around probe_chain's
// chase+vec step (N = 2048 steps, the (64, 128) vector stage):
//   carry5 (1): five (64, 128) buffers carried through the loop, not one;
//   cond (2): the vector stage inside a data-dependent branch (idx >= 0);
//   datacond (4): the loop also ends on a value of the body (idx < 1024);
//   sort (8): the 19-exchange Batcher network on 8 keys with their codes
//     (lanes 8-15 and 16-23 of the row; K1's sort_children);
//   push8 (16): 8 predicated pushes of lanes 32-39 onto an 8-entry stack
//     (the JAX body's SMEM scratch).
// One block of kBodyThreads = 256 threads per copy; each (64, 128) operand
// is spread 32 values a thread, column t & 127, so the buffers stay in
// registers. (1,024 and 512 threads a copy were slower at the full card
// for all nine sets: PERF.md, section 6.)
//
// What bounds a step is its one dependent chain: the row's load, the
// vector stage, the block's minimum, the next row's index. The design
// keeps that chain short, in the warp schedule's way (bvh_tile.cu):
// - one barrier a step. Each warp folds its minimum in 5 shuffles and
//   writes it to its slot of `part`, double-buffered by the step's parity,
//   so a slot is rewritten only after every warp has passed the next
//   step's barrier; after the barrier every warp reads the partials, one
//   a lane, and folds them in log2(warps) shuffles. A float
//   minimum is exact in any order (the table holds no NaN; a signed zero
//   only meets m > 1e30), so every order gives the plain version's bits.
// - the scalar features once per copy, as the JAX body runs them once per
//   program on its scalar unit: warp 0 alone runs them, after its share of
//   the vector stage, on the row lanes its own load brought (lanes 8-23,
//   shuffled out) and a second load (lanes 32-39); the network as its 6
//   layers of disjoint exchanges across lanes 0-7, the pushes by every lane
//   of the warp alike onto a stack in shared memory. Warp 0 also writes
//   the next index but the minimum's part (the row's lane 0, which its
//   lane 0 loaded, plus kid[0] & zero and sp & zero) to `word`, with sp
//   (the JAX body's smem[8]), double-buffered as `part`: no other thread
//   loads lane 0 or holds it across the step.
// The JAX body's dead values (kids[0] & 0, sp & 0, the buffers and stack,
// which the output does not read) are kept alive the card's way: the masks
// take a runtime zero, and the thread whose index is that zero writes its
// value 0 of every buffer (the others' bits, and'ed with zero, or'ed in)
// and the stack's word 0 to `aux`.
enum { kCarry5 = 1, kCond = 2, kDataCond = 4, kSort = 8, kPush8 = 16 };
// The network of experiments/probe_body.py (_SORT_NETWORKS[8]), its 19
// exchanges in order as 6 layers of disjoint pairs ((0, 1) (2, 3) (4, 5)
// (6, 7); (0, 2) (1, 3) (4, 6) (5, 7); (1, 2) (5, 6); (0, 4) (1, 5) (2, 6)
// (3, 7); (2, 4) (3, 5); (1, 2) (3, 4) (5, 6)): nibble l of layer s is
// position l's partner in it, l itself where the layer leaves it alone.
__device__ constexpr unsigned kSortLayers[6] = {
    0x67452301u, 0x54761032u, 0x75643120u, 0x32107654u, 0x76325410u,
    0x75634120u};
constexpr int kBodyThreads = 256;

// The network on a warp that holds position l of the 8 on lanes l, l + 8,
// ...: each lane's key and code become position l's after the 6 layers.
__device__ __forceinline__ void sort8(float& key, int& kid, int l) {
#pragma unroll
  for (int s = 0; s < 6; ++s) {
    const int p = (kSortLayers[s] >> (4 * l)) & 7;
    const float pk = __shfl_sync(~0u, key, p);
    const int pid = __shfl_sync(~0u, kid, p);
    // pair (a, b) swaps where key[a] > key[b]
    const bool sw = l < p ? key > pk : pk > key;
    key = sw ? pk : key;
    kid = sw ? pid : kid;
  }
}

template <int kF>
__global__ void __launch_bounds__(kBodyThreads) body_kernel(
    const float* __restrict__ tab, int* __restrict__ out,
    float* __restrict__ aux, int zero) {
  constexpr int kW = kBodyThreads / 32, kV = 64 * 128 / kBodyThreads;
  constexpr int kNC = (kF & kCarry5) ? 5 : 1;
  __shared__ float part[2][kW];        // each warp's minimum
  __shared__ int word[2][2];           // the next index but m's part; sp
  __shared__ int stack[8];
  const int t = threadIdx.x, j = t & 127, lane = t & 31, w = t >> 5;
  float buf[kNC][kV];
  for (int c = 0; c < kNC; ++c)
    for (int k = 0; k < kV; ++k) buf[c][k] = (float)c;
  if (w == 0) {                        // every lane alike
    if (lane < 8) stack[lane] = 0;
    word[1][1] = 0;
    __syncwarp();
  }
  int i = 0, idx = 0;
  while (i < kChainN && (!(kF & kDataCond) || idx < kChainNN)) {
    const int b = i & 1;               // every step takes the barrier
    const float* row = tab + idx * 128;
    const bool vec = !(kF & kCond) || idx >= 0;
    const float rj = __ldg(row + j);
    int val = 0;
    if ((kF & kPush8) && w == 0)
      val = __float_as_int(__ldg(row + 32 + (lane & 7)));
    if (vec) {
      float m = kInfv;
#pragma unroll
      for (int k = 0; k < kV; ++k) {
        const float v = stage_value(rj, buf[0][k]);
        m = fminf(m, v);
        for (int c = 0; c < kNC; ++c) buf[c][k] = v < 0.5f ? v : buf[c][k];
      }
      put_warp_min(m, part[b], lane, w);
    }
    if (w == 0) {
      // lane 0's rj is the row's lane 0
      int base = vec ? __float_as_int(rj) : idx + 1;
      if (kF & kSort) {
        // position l on lanes l, l + 8, ...; l is taken anew each step
        // (i & zero is 0): nvcc would hold its six partners across the
        // loop, six registers of every thread
        const int l = (lane ^ (i & zero)) & 7;
        float key = __shfl_sync(~0u, rj, 8 + l);
        int kid = __float_as_int(__shfl_sync(~0u, rj, 16 + l));
        sort8(key, kid, l);
        base = base + (__shfl_sync(~0u, kid, 0) & zero);
      }
      if (kF & kPush8) {
        int sp = word[b ^ 1][1];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int v = __shfl_sync(~0u, val, k);
          const bool ok = v != 0;
          stack[ok ? min(sp, 7) : 7] = v;
          sp = sp + (ok ? 1 : 0);
        }
        word[b][1] = sp - 8;
        base = base + (sp & zero);
      }
      if (lane == 0) word[b][0] = base;
    }
    __syncthreads();
    int nxt = word[b][0];
    if (vec) nxt = nxt + (block_min_of<kW>(part[b], lane) > 1e30f ? 1 : 0);
    idx = nxt;
    i += 1;
  }
  if (t == 0) out[blockIdx.x] = idx + i;
  __syncthreads();                     // warp 0's stack, for thread zero
  if (t == zero) {
    // value 0 with the bits of the others and'ed with zero or'ed in, so
    // that nvcc keeps every value of every buffer (taking buf[c][0] alone,
    // it drops the others of buffers 1-4, which nothing else reads)
    for (int c = 0; c < 5; ++c) {
      int a = 0;
      if (c < kNC) {
        a = __float_as_int(buf[c][0]);
        for (int k = 1; k < kV; ++k) a |= __float_as_int(buf[c][k]) & zero;
      }
      aux[blockIdx.x * 6 + c] = __int_as_float(a);
    }
    aux[blockIdx.x * 6 + 5] = (kF & kPush8) ? __int_as_float(stack[zero & 7])
                                            : 0.f;
  }
}

// body_kernel folds the network's codes into the next index and'ed with
// zero, so none of its outputs reads them: this kernel is the network's
// check. One warp a set of 8 keys and codes, sorted by sort8 as warp 0 of
// body_kernel sorts a row's.
__global__ void __launch_bounds__(32) sort8_kernel(
    const float* __restrict__ keys, const int* __restrict__ kids,
    float* __restrict__ out_keys, int* __restrict__ out_kids) {
  const int l = threadIdx.x & 7, at = blockIdx.x * 8 + l;
  float key = keys[at];
  int kid = kids[at];
  sort8(key, kid, l);
  if (threadIdx.x < 8) {
    out_keys[at] = key;
    out_kids[at] = kid;
  }
}

// ---------------------------------------------------------------------------
// probe_dyn_cost: experiments/probe_dyn_cost.py, make :28-42 and the bodies
// :45-83. N_IT = 2000 iterations add (8, 128) tiles of a (4096, 128) f32
// table (2 MB: it stays in L2) to an (8, 128) accumulator; the tile's row
// is int(acc[0, 0]) % 64 + i % 64 (% 512 for dynrow1), so each load depends
// on the last sum.
//   static: tab[0:8] every iteration, loaded with an asm volatile load so
//     that nvcc cannot hoist it out of the loop (no dependence);
//   dyn1, dyn4: one, or four (64 rows apart), 4 KB tiles at the index;
//   dynrow1: one 512-byte row broadcast over the 8 rows;
//   async4: the four tiles of dyn4 as four bulk copies in flight for each
//     iteration (cp.async.bulk global -> shared, the TMA's bulk form,
//     completing on an mbarrier with complete_tx), the card's counterpart
//     of make_async_copy with DMA semaphores.
// One block of kDynThreads = 256 threads per copy: warp w owns row w of
// every tile (dynrow1: the row), each lane 4 consecutive values, a 16-byte
// load. Only acc[0, 0] is on the chain, and it reads nothing but column 0
// of each tile's first row: each warp keeps its own copy of it and adds
// those words in the same order, so the copy is acc[0, 0] bit for bit and
// no barrier passes it on. The words (151 of them, 575 for dynrow1) are
// staged in shared memory before the loop: L1 does not keep them between
// the tiles it streams, so read from the table each step waited on L2.
// The tiles leave the chain: a warp loads iteration i's as soon as the
// chain gives its row, into a ring of kDynDepth iterations in registers,
// and adds them while the chain runs ahead; the loads are marked to leave
// L1 first (evict_first), which ran faster with the card full. async4's
// ring is shared-memory stages, each with a `full` and an `empty`
// mbarrier and their phase parities (the TMA pipeline). Bound with one
// copy: the chain's shared load and arithmetic an iteration, or the
// tiles' bytes through the SM; with the card full, those bytes through
// L1 and L2.
enum { kStatic, kDyn1, kDyn4, kDynRow1, kAsync4 };
constexpr int kDynIters = 2000, kDynThreads = 256, kDynWarps = 8;

// Iterations in flight: 2 ran faster than 4 and 8 in every body and at
// both shapes (a warp has 6 scoreboards for its loads in flight, and
// each register a load holds costs copies a SM)
constexpr int kDynDepth = 2;
// async4's ring (dynamic shared memory): [stage][tile] 4 KB
constexpr int kAsyncBytes = kDynDepth * 4 * 4096;
static_assert(kDynIters % kDynDepth == 0, "whole rings");

// tiles an iteration adds
__host__ __device__ constexpr int dyn_tiles(int b) {
  return b == kDyn4 || b == kAsync4 ? 4 : 1;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ float4 load_volatile(const float4* p) {
  float4 v;
  asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

// a tile's 16 bytes, the first out of L1
__device__ __forceinline__ float4 load_streamed(const float4* p) {
  float4 v;
  asm("ld.global.L1::evict_first.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Iteration i's index at a00 = acc[0, 0]: int(a00) % 64 (% 512) + i % 64,
// Python's floor modulo, which by a power of two keeps the low bits
template <int kB>
__device__ __forceinline__ int dyn_idx(float a00, int i) {
  return ((int)a00 & (kB == kDynRow1 ? 511 : 63)) + (i & 63);
}

// The first row of tile q of the index: dynrow1's row idx; the others'
// idx * 8 + 64 * q
template <int kB>
__device__ __forceinline__ int dyn_row(int idx, int q) {
  return kB == kDynRow1 ? idx : idx * 8 + 64 * q;
}

// The rows whose column 0 a chain reads: dynrow1's rows 0-574 (idx <=
// 511 + 63); the others' tiles' first rows, every 8th row of 0-1200 (idx <=
// 126). col0[j] holds row j * chain_step's word, so tile q's is at idx + 8q.
__host__ __device__ constexpr int chain_step(int b) {
  return b == kDynRow1 ? 1 : 8;
}
__host__ __device__ constexpr int chain_words(int b) {
  return b == kDynRow1 ? 575 : 151;
}

// a00 past the tiles of the index: column 0 of each tile's first row, in
// order
template <int kB>
__device__ __forceinline__ float dyn_chain(const float* col0, float a00,
                                           int idx) {
  float c[dyn_tiles(kB)];
#pragma unroll
  for (int q = 0; q < dyn_tiles(kB); ++q) c[q] = col0[idx + 8 * q];
#pragma unroll
  for (int q = 0; q < dyn_tiles(kB); ++q) a00 = a00 + c[q];
  return a00;
}

// dyn1, dyn4, dynrow1: the ring in registers. Returns the thread's acc.
template <int kB>
__device__ __forceinline__ float4 dyn_loads(const float* tab,
                                            const float* col0) {
  constexpr int kT = dyn_tiles(kB), kD = kDynDepth;
  const int lane = threadIdx.x & 31;
  const int rw = kB == kDynRow1 ? 0 : threadIdx.x >> 5;
  const float4* at = reinterpret_cast<const float4*>(tab) + rw * 32 + lane;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f), ring[kD][kT];
  float a00 = 0.f;                         // this warp's acc[0, 0]
#pragma unroll
  for (int s = 0; s < kD; ++s) {
    const int idx = dyn_idx<kB>(a00, s);
#pragma unroll
    for (int q = 0; q < kT; ++q)
      ring[s][q] = load_streamed(at + dyn_row<kB>(idx, q) * 32);
    a00 = dyn_chain<kB>(col0, a00, idx);
  }
  for (int i = 0; i < kDynIters; i += kD) {
#pragma unroll
    for (int s = 0; s < kD; ++s) {
      // slot s: iteration i + s's tiles added, i + s + kD's loaded
      const bool more = i + s + kD < kDynIters;
      const int idx = dyn_idx<kB>(a00, i + s + kD);
      float4 v[kT];
      if (more) {
#pragma unroll
        for (int q = 0; q < kT; ++q)
          v[q] = load_streamed(at + dyn_row<kB>(idx, q) * 32);
      }
#pragma unroll
      for (int q = 0; q < kT; ++q) acc = add4(acc, ring[s][q]);
      if (more) {
#pragma unroll
        for (int q = 0; q < kT; ++q) ring[s][q] = v[q];
        a00 = dyn_chain<kB>(col0, a00, idx);
      }
    }
  }
  return acc;
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
}

// async4: iteration i's four tiles as four bulk copies of 4 KB into stage
// i % kD, issued by thread 0 on the stage's `full` mbarrier once every
// warp has arrived on its `empty` one, having read the stage's last
// iteration. Returns the thread's acc.
__device__ __forceinline__ float4 dyn_async4(const float* tab,
                                             const float* col0) {
  constexpr int kD = kDynDepth;
  extern __shared__ __align__(128) float4 ring[];     // [stage][tile]
  __shared__ __align__(8) uint64_t full[kD], empty[kD];
  const int t = threadIdx.x;
  if (t == 0) {
    for (int s = 0; s < kD; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;"
                   :: "r"(smem_addr(&full[s])) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                   :: "r"(smem_addr(&empty[s])), "r"(kDynWarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float a00 = 0.f;                         // this warp's acc[0, 0]
  // iteration i's copies into stage s, then a00 past its tiles
  auto start = [&](int i, int s) {
    const int idx = dyn_idx<kAsync4>(a00, i);
    if (t == 0) {
      if (i >= kD) mbar_wait(smem_addr(&empty[s]), (i / kD - 1) & 1);
      const uint32_t b = smem_addr(&full[s]);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                   :: "r"(b), "r"(4 * 4096) : "memory");
#pragma unroll
      for (int q = 0; q < 4; ++q)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
            "::bytes [%0], [%1], %2, [%3];"
            :: "r"(smem_addr(ring + (s * 4 + q) * 256)),
               "l"(tab + dyn_row<kAsync4>(idx, q) * 128), "r"(4096),
               "r"(b)
            : "memory");
    }
    a00 = dyn_chain<kAsync4>(col0, a00, idx);
  };
#pragma unroll
  for (int s = 0; s < kD; ++s) start(s, s);
  for (int i = 0; i < kDynIters; i += kD) {
#pragma unroll
    for (int s = 0; s < kD; ++s) {
      mbar_wait(smem_addr(&full[s]), (i / kD) & 1);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc = add4(acc, ring[(s * 4 + q) * 256 + t]);
      __syncwarp();
      if ((t & 31) == 0)
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];"
                     :: "r"(smem_addr(&empty[s])) : "memory");
      if (i + s + kD < kDynIters) start(i + s + kD, s);
    }
  }
  return acc;
}

template <int kB>
__global__ void __launch_bounds__(kDynThreads) dyn_cost_kernel(
    const float* __restrict__ tab, float* __restrict__ out) {
  const int t = threadIdx.x;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (kB == kStatic) {
    const float4* at = reinterpret_cast<const float4*>(tab) + t;
    for (int i = 0; i < kDynIters; ++i) acc = add4(acc, load_volatile(at));
  } else {
    // the chain's words, staged once: L1 does not keep them between the
    // tiles it streams
    __shared__ float col0[chain_words(kB)];
    for (int j = t; j < chain_words(kB); j += kDynThreads)
      col0[j] = tab[j * chain_step(kB) * 128];
    __syncthreads();
    if constexpr (kB == kAsync4)
      acc = dyn_async4(tab, col0);
    else
      acc = dyn_loads<kB>(tab, col0);
  }
  reinterpret_cast<float4*>(out)[blockIdx.x * kDynThreads + t] = acc;
}

// ---------------------------------------------------------------------------
// vpu_dtype_bench: experiments/vpu_dtype_bench.py, make :19-35. ITERS =
// 2000 rounds of x = min(max(x * c1 - c2, x), c3) (mul, sub, max, min: the
// slab test's op mix) on a (rows, 128) array of one type. Bound: the CUDA
// cores' issue rate for the type. Each thread owns kVpuWords 32-bit words:
// float32 and int32 one value a word, bfloat16 a packed __nv_bfloat162
// (__hmul2, __hsub2, __hmax2, __hmin2), int16 a packed pair: the subtract,
// max and min through the SIMD intrinsics __vsub2, __vmaxs2, __vmins2; the
// multiply, which has no 16-bit SIMD form, in 32-bit registers (each
// half's product, masked and joined). The constants come in as arguments
// (their bits, packed pairs for the 16-bit types): in the int types and
// bfloat16, 1.000001 and 0.5 round to 1 and 0, and as literals nvcc would
// fold x * 1 and x - 0 away.
//
// The design for the card: the thread's words are independent chains,
// and each round applies one operation to all of them before the next
// (vpu_round), so a warp issues kVpuWords independent instructions back
// to back and fewer warps hide an operation's latency. The rounds are
// unrolled by kVpuUnroll, so that the loop's counter, compare and branch
// are under 2% of the loop's instructions (int32's 3 a word the fewest);
// the op count read from the SASS divides by the unroll and by kVpuWords.
// A block is kVpuThreads threads over kVpuBlockWords consecutive words
// (word i of thread t at i * kVpuThreads + t: each load and store
// coalesced), 16 blocks an SM. On an H100, 2 words a thread at 128
// threads ran 0.81x the time of 4 at 64 on float32 with the card full
// and 0.76x at one copy, where 4 words leave half of an SM's
// sub-partitions idle; only 4 words a thread make whole waves of every
// case: 2 leave a 256-row copy of a 32-bit type 16.5 copies of room (16
// copies, 2,048 of 2,112 blocks).
enum { kF32, kBF16, kI32, kI16 };
constexpr int kVpuIters = 2000, kVpuUnroll = 40, kVpuWords = 2,
              kVpuThreads = 128, kVpuBlockWords = kVpuWords * kVpuThreads;

__device__ __forceinline__ __nv_bfloat162 as_bf2(uint32_t v) {
  return *reinterpret_cast<const __nv_bfloat162*>(&v);
}
__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int kT>
__device__ __forceinline__ uint32_t vpu_mul(uint32_t x, uint32_t c) {
  if constexpr (kT == kF32) {
    return __float_as_uint(__uint_as_float(x) * __uint_as_float(c));
  } else if constexpr (kT == kBF16) {
    return bf2_bits(__hmul2(as_bf2(x), as_bf2(c)));
  } else if constexpr (kT == kI32) {
    return (uint32_t)((int)x * (int)c);
  } else {
    const uint32_t m = (uint32_t)(int)(int16_t)(c & 0xffff);
    return ((x * m) & 0xffffu) | ((x & 0xffff0000u) * m);
  }
}

template <int kT>
__device__ __forceinline__ uint32_t vpu_sub(uint32_t a, uint32_t c) {
  if constexpr (kT == kF32) {
    return __float_as_uint(__uint_as_float(a) - __uint_as_float(c));
  } else if constexpr (kT == kBF16) {
    return bf2_bits(__hsub2(as_bf2(a), as_bf2(c)));
  } else if constexpr (kT == kI32) {
    return (uint32_t)((int)a - (int)c);
  } else {
    return __vsub2(a, c);
  }
}

template <int kT>
__device__ __forceinline__ uint32_t vpu_max(uint32_t a, uint32_t b) {
  if constexpr (kT == kF32) {
    return __float_as_uint(fmaxf(__uint_as_float(a), __uint_as_float(b)));
  } else if constexpr (kT == kBF16) {
    return bf2_bits(__hmax2(as_bf2(a), as_bf2(b)));
  } else if constexpr (kT == kI32) {
    return (uint32_t)max((int)a, (int)b);
  } else {
    return __vmaxs2(a, b);
  }
}

template <int kT>
__device__ __forceinline__ uint32_t vpu_min(uint32_t a, uint32_t c) {
  if constexpr (kT == kF32) {
    return __float_as_uint(fminf(__uint_as_float(a), __uint_as_float(c)));
  } else if constexpr (kT == kBF16) {
    return bf2_bits(__hmin2(as_bf2(a), as_bf2(c)));
  } else if constexpr (kT == kI32) {
    return (uint32_t)min((int)a, (int)c);
  } else {
    return __vmins2(a, c);
  }
}

// One round on every word of the thread, one operation at a time.
template <int kT>
__device__ __forceinline__ void vpu_round(uint32_t (&v)[kVpuWords],
                                          uint32_t c1, uint32_t c2,
                                          uint32_t c3) {
  uint32_t a[kVpuWords];
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) a[i] = vpu_mul<kT>(v[i], c1);
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) a[i] = vpu_sub<kT>(a[i], c2);
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) a[i] = vpu_max<kT>(a[i], v[i]);
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) v[i] = vpu_min<kT>(a[i], c3);
}

// x: `words` words (a multiple of kVpuBlockWords); out: copies x words,
// one block per kVpuBlockWords of it.
template <int kT>
__global__ void __launch_bounds__(kVpuThreads, 2048 / kVpuThreads)
vpu_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
           long long words, uint32_t c1, uint32_t c2, uint32_t c3) {
  const long long base =
      (long long)blockIdx.x * kVpuBlockWords + threadIdx.x;
  const long long in = base % words;
  uint32_t v[kVpuWords];
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) v[i] = x[in + i * kVpuThreads];
#pragma unroll kVpuUnroll
  for (int it = 0; it < kVpuIters; ++it) vpu_round<kT>(v, c1, c2, c3);
#pragma unroll
  for (int i = 0; i < kVpuWords; ++i) out[base + i * kVpuThreads] = v[i];
}

}  // namespace

// ---------------------------------------------------------------------------
// The C entries. Each launches on `stream`, one block (or one grid) per copy
// of its probe, and returns cudaGetLastError(): a refused launch (too much
// shared memory, a bad body) never runs. Each timed family also has its
// launch shape in `Launch`, which rt_probe_occupancy turns into resident
// blocks per SM, so that the wrappers can size a launch that fills the card.
namespace {

enum { kProbeGather, kProbeMosaic3, kProbeChain, kProbeBody, kProbeDynCost,
       kProbeVpu };

struct Launch {
  const void* fn = nullptr;
  int threads = 0;
  int smem = 0;                 // dynamic shared memory, bytes
};

template <typename K>
Launch launch_of(K* fn, int threads, int smem = 0) {
  Launch l;
  l.fn = reinterpret_cast<const void*>(fn);
  l.threads = threads;
  l.smem = smem;
  return l;
}

Launch gather_launch(int body, int smem, int pages) {
  const int words = body == kChain ? 1024
                    : body == kFields ? kFields56 * 1024
                                      : kPageFields * pages * 1024;
  const int bytes = smem ? words * 4 : 0;
  constexpr int cs = kGatherThreadsChainShared,
                cg = kGatherThreadsChainGlobal, s = kGatherThreadsShared,
                g = kGatherThreadsGlobal;
  if (body == kChain)
    return smem ? launch_of(gather_kernel<kChain, true, cs>, cs, bytes)
                : launch_of(gather_kernel<kChain, false, cg>, cg);
  if (body == kFields)
    return smem ? launch_of(gather_kernel<kFields, true, s>, s, bytes)
                : launch_of(gather_kernel<kFields, false, g>, g);
  if (body == kPages && (pages == 1 || pages == 2 || pages == 4
                         || pages == 8) && !(smem && pages > 2))
    return smem ? launch_of(gather_kernel<kPages, true, s>, s, bytes)
                : launch_of(gather_kernel<kPages, false, g>, g);
  return Launch();
}

Launch mosaic3_launch(int mode) {
  switch (mode) {
    case kNone:
      return launch_of(mosaic3_kernel<kNone>, kM3Threads);
    case kExtract:
      return launch_of(mosaic3_kernel<kExtract>, kM3Threads);
    case kSlice:
      return launch_of(mosaic3_kernel<kSlice>, kM3Threads);
    case kDepExtract:
      return launch_of(mosaic3_kernel<kDepExtract>, kM3Threads);
    case kDepSlice:
      return launch_of(mosaic3_kernel<kDepSlice>, kM3Threads);
  }
  return Launch();
}

template <int kS>
Launch chain_launch_s(int mode) {
  switch (mode) {
    case kChase:
      return launch_of(chain_scalar_kernel<kChase, kS>, kScalarBlock);
    case kChaseLocal:
      return launch_of(chain_scalar_kernel<kChaseLocal, kS>, kScalarBlock);
    case kChaseShared:
      return launch_of(chain_scalar_kernel<kChaseShared, kS>, kScalarBlock);
    case kChaseVec: return launch_of(chain_vec_kernel<kS>, kVecThreads);
  }
  return Launch();
}

Launch chain_launch(int mode, int streams) {
  if (streams == 1) return chain_launch_s<1>(mode);
  if (streams == 2) return chain_launch_s<2>(mode);
  if (streams == 4) return chain_launch_s<4>(mode);
  return Launch();
}

// the nine feature sets of experiments/probe_body.py:126-136
Launch body_launch(int feats) {
  switch (feats) {
    case 0: return launch_of(body_kernel<0>, kBodyThreads);
    case kCarry5: return launch_of(body_kernel<kCarry5>, kBodyThreads);
    case kCond: return launch_of(body_kernel<kCond>, kBodyThreads);
    case kDataCond: return launch_of(body_kernel<kDataCond>, kBodyThreads);
    case kSort: return launch_of(body_kernel<kSort>, kBodyThreads);
    case kPush8: return launch_of(body_kernel<kPush8>, kBodyThreads);
    case kCond | kCarry5:
      return launch_of(body_kernel<kCond | kCarry5>, kBodyThreads);
    case kSort | kPush8:
      return launch_of(body_kernel<kSort | kPush8>, kBodyThreads);
    case 31: return launch_of(body_kernel<31>, kBodyThreads);
  }
  return Launch();
}

Launch dyn_cost_launch(int body) {
  switch (body) {
    case kStatic: return launch_of(dyn_cost_kernel<kStatic>, kDynThreads);
    case kDyn1: return launch_of(dyn_cost_kernel<kDyn1>, kDynThreads);
    case kDyn4: return launch_of(dyn_cost_kernel<kDyn4>, kDynThreads);
    case kDynRow1: return launch_of(dyn_cost_kernel<kDynRow1>, kDynThreads);
    case kAsync4:
      return launch_of(dyn_cost_kernel<kAsync4>, kDynThreads, kAsyncBytes);
  }
  return Launch();
}

Launch vpu_launch(int dtype) {
  switch (dtype) {
    case kF32: return launch_of(vpu_kernel<kF32>, kVpuThreads);
    case kBF16: return launch_of(vpu_kernel<kBF16>, kVpuThreads);
    case kI32: return launch_of(vpu_kernel<kI32>, kVpuThreads);
    case kI16: return launch_of(vpu_kernel<kI16>, kVpuThreads);
  }
  return Launch();
}

Launch probe_launch(int probe, int body, int arg, int arg2) {
  switch (probe) {
    case kProbeGather: return gather_launch(body, arg, arg2);
    case kProbeMosaic3: return mosaic3_launch(body);
    case kProbeChain: return chain_launch(body, arg);
    case kProbeBody: return body_launch(body);
    case kProbeDynCost: return dyn_cost_launch(body);
    case kProbeVpu: return vpu_launch(body);
  }
  return Launch();
}

// Launches l on `blocks` blocks with `args`; above 48 KB of shared memory
// the kernel is first allowed that much.
int launch(const Launch& l, int blocks, void** args, void* stream) {
  if (!l.fn || blocks <= 0) return (int)cudaErrorInvalidValue;
  if (l.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaError_t e = cudaLaunchKernel(
      l.fn, dim3(blocks), dim3(l.threads), args, l.smem,
      static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// Resident blocks per SM of a timed probe's kernel (probe: 0 gather, 1
// mosaic3, 2 chain, 3 body, 4 dyn_cost, 5 vpu; body, arg and arg2 as the
// probe's entry takes them: gather smem and pages, chain streams).
extern "C" int rt_probe_occupancy(int probe, int body, int arg, int arg2,
                                  int* blocks_per_sm) {
  const Launch l = probe_launch(probe, body, arg, arg2);
  if (!l.fn) return (int)cudaErrorInvalidValue;
  if (l.smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        l.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, l.smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, l.fn, l.threads, l.smem);
}

// probe_mosaic: x (16, 128) f32, out (16, 128) f32.
extern "C" int rt_probe_mosaic(int body, const float* x, float* out,
                               void* stream) {
  if (body < kDot || body > kArgminLane) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == kDot)
    mosaic_dot_kernel<<<2, 1024, 0, s>>>(x, out);
  else
    mosaic_kernel<<<1, 128, 0, s>>>(body, x, out);
  return (int)cudaGetLastError();
}

// probe_mosaic2: the same shapes.
extern "C" int rt_probe_mosaic2(int body, const float* x, float* out,
                                void* stream) {
  if (body < kDotInLoop || body > kDynStore8InWhile)
    return (int)cudaErrorInvalidValue;
  mosaic2_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(body, x,
                                                                    out);
  return (int)cudaGetLastError();
}

// probe_gather. kTake: tbl and out (rows, 128) 32-bit words, idx (rows,
// 128) int32 in [0, 128) (axis 1) or [0, rows) (axis 0), all 16-byte
// aligned, axis 0 or 1, rows from 1 to 2^24 - 1. kChain: tbl (8, 128)
// int32; kFields: (56, 8, 128) f32; kPages: (28, pages, 8, 128) f32; idx
// (8, 128) int32, out (copies, 8, 128) int32; smem: the table in shared
// memory.
extern "C" int rt_probe_gather(int body, const void* tbl, const int* idx,
                               void* out, int rows, int axis, int pages,
                               int smem, int copies, void* stream) {
  if (body == kTake) {
    if (rows < 1 || rows >= (1 << 24) || (axis != 0 && axis != 1))
      return (int)cudaErrorInvalidValue;
    const int groups = rows * 32;
    const int blocks = (groups + kTakeThreads - 1) / kTakeThreads;
    const int* t = static_cast<const int*>(tbl);
    const int4* i = reinterpret_cast<const int4*>(idx);
    int4* o = static_cast<int4*>(out);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (axis == 1)
      gather_take_kernel<1><<<blocks, kTakeThreads, 0, s>>>(t, i, o, groups);
    else
      gather_take_kernel<0><<<blocks, kTakeThreads, 0, s>>>(t, i, o, groups);
    return (int)cudaGetLastError();
  }
  const float* t = static_cast<const float*>(tbl);
  int* o = static_cast<int*>(out);
  void* args[] = {&t, &idx, &o, &pages};
  return launch(gather_launch(body, smem, pages), copies, args, stream);
}

// probe_mosaic3: tab (1024, 128) f32, out (copies, 64, 128) f32.
extern "C" int rt_probe_mosaic3(int mode, const float* tab, float* out,
                                int copies, void* stream) {
  void* args[] = {&tab, &out};
  return launch(mosaic3_launch(mode), copies, args, stream);
}

// probe_chain: tab (1024, 128) f32, out and aux (copies,) int32 (aux: the
// fold of chase+vec's minima, which the one-thread modes, having none,
// leave alone; may be null); streams 1, 2, 4.
extern "C" int rt_probe_chain_aux(int mode, int streams, const float* tab,
                                  int* out, int* aux, int copies,
                                  void* stream) {
  const Launch l = chain_launch(mode, streams);
  if (mode == kChaseVec) {
    void* args[] = {&tab, &out, &aux};
    return launch(l, copies, args, stream);
  }
  void* args[] = {&tab, &out, &copies};
  return launch(l, (copies + kScalarBlock - 1) / kScalarBlock, args, stream);
}

// probe_chain without aux, the entry of the bodies before it had one.
extern "C" int rt_probe_chain(int mode, int streams, const float* tab,
                              int* out, int copies, void* stream) {
  return rt_probe_chain_aux(mode, streams, tab, out, nullptr, copies,
                            stream);
}

// probe_body: feats a bit set of kCarry5 ... kPush8; tab (1024, 128) f32,
// out (copies,) int32, aux (copies, 6) f32; zero must be 0.
extern "C" int rt_probe_body(int feats, const float* tab, int* out,
                             float* aux, int zero, int copies,
                             void* stream) {
  void* args[] = {&tab, &out, &aux, &zero};
  return launch(body_launch(feats), copies, args, stream);
}

// body_kernel's network alone: keys (sets, 8) f32 and kids (sets, 8) int32
// in, each set sorted into out_keys and out_kids.
extern "C" int rt_probe_sort8(const float* keys, const int* kids,
                              float* out_keys, int* out_kids, int sets,
                              void* stream) {
  void* args[] = {&keys, &kids, &out_keys, &out_kids};
  return launch(launch_of(sort8_kernel, 32), sets, args, stream);
}

// probe_dyn_cost: tab (4096, 128) f32, out (copies, 8, 128) f32.
extern "C" int rt_probe_dyn_cost(int body, const float* tab, float* out,
                                 int copies, void* stream) {
  void* args[] = {&tab, &out};
  return launch(dyn_cost_launch(body), copies, args, stream);
}

// vpu_dtype_bench: x `words` 32-bit words (rows x 128 values, a multiple
// of kVpuBlockWords), out (copies, words) words; c1, c2, c3: the
// constants' bits (packed pairs for bf16 and int16).
extern "C" int rt_probe_vpu(int dtype, const void* x, void* out,
                            long long words, int copies, unsigned c1,
                            unsigned c2, unsigned c3, void* stream) {
  if (words < 1 || words % kVpuBlockWords || copies < 1)
    return (int)cudaErrorInvalidValue;
  const uint32_t* xp = static_cast<const uint32_t*>(x);
  uint32_t* op = static_cast<uint32_t*>(out);
  void* args[] = {&xp, &op, &words, &c1, &c2, &c3};
  return launch(vpu_launch(dtype), (int)(words / kVpuBlockWords * copies),
                args, stream);
}
