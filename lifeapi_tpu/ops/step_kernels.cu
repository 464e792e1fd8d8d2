// Fused multi-generation Life rollouts for NVIDIA Hopper (sm_90a), called
// from JAX through the XLA foreign function interface (ops/step_cuda.py).
//
// Boards are uint32[B, 64, 2] in even/odd packing: for column x, word 0
// holds rows y = 0, 2, .., 62 and word 1 rows y = 1, 3, .., 63
// (core/bitops.interleave_split).  In this packing the +-1 row rotate of a
// 64-bit column is one 32-bit rotate plus a free word swap.
//
// LANES consecutive threads of a warp own one board; thread j holds the
// CPL = 64 / LANES adjacent columns j*CPL .. j*CPL+CPL-1 in registers for
// the whole rollout.  Each generation is the carry-save-adder / Rokicki
// netlist of core/step.step: the vertical 3-sums of a column are computed
// in-thread, and the two columns just outside a thread's range come from
// its neighbour threads by warp shuffle (the torus wraps inside the
// LANES-wide shuffle segment).  Device memory is read once and written
// once per rollout; the MPC variant streams one generation of toggles per
// step, and the catalyst variant steps the shared baseline beside each
// board.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 256;

template <int CPL>
struct Board {
  uint32_t e[CPL];
  uint32_t o[CPL];
};

template <int CPL>
__device__ __forceinline__ void load(const uint32_t* p, Board<CPL>& s) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    uint4 v = q[i];
    s.e[2 * i] = v.x;
    s.o[2 * i] = v.y;
    s.e[2 * i + 1] = v.z;
    s.o[2 * i + 1] = v.w;
  }
}

template <int CPL>
__device__ __forceinline__ void store(uint32_t* p, const Board<CPL>& s) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < CPL / 2; ++i) {
    q[i] = make_uint4(s.e[2 * i], s.o[2 * i], s.e[2 * i + 1], s.o[2 * i + 1]);
  }
}

template <int CPL>
__device__ __forceinline__ void zero(Board<CPL>& s) {
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    s.e[i] = 0u;
    s.o[i] = 0u;
  }
}

__device__ __forceinline__ uint32_t rok(uint32_t a, uint32_t s0, uint32_t s1,
                                        uint32_t u0, uint32_t u1, uint32_t b0,
                                        uint32_t b1) {
  // Rokicki's next-state formula over the west/east 3-sums (u*, b*) and
  // the centre column's own pair sum (s0, s1); reference
  // LifeAPI.hpp:837-848, ops identical to core/step.step.
  uint32_t ts0 = b0 ^ u0;
  uint32_t ts1 = (b0 & u0) | (ts0 & s0);
  return (b1 ^ u1 ^ ts1 ^ s1) & ((b1 | u1) ^ (ts1 | s1)) & ((ts0 ^ s0) | a);
}

// One generation of the board segment held by this thread.
template <int CPL>
__device__ __forceinline__ void step(Board<CPL>& s, int up, int dn) {
  constexpr int LANES = 64 / CPL;
  uint32_t xe[CPL], xo[CPL], ue[CPL], uo[CPL];
  // vertical 3-sums with one column of halo on each side
  uint32_t c0e[CPL + 2], c0o[CPL + 2], c1e[CPL + 2], c1o[CPL + 2];
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    uint32_t e = s.e[i], o = s.o[i];
    uint32_t re = (o << 1) | (o >> 31);  // rows y-1 of the even words
    uint32_t rr = (e >> 1) | (e << 31);  // rows y+1 of the odd words
    xe[i] = re ^ o;
    xo[i] = e ^ rr;
    ue[i] = re & o;
    uo[i] = e & rr;
    c0e[i + 1] = xe[i] ^ e;
    c0o[i + 1] = xo[i] ^ o;
    c1e[i + 1] = (xe[i] & e) | ue[i];
    c1o[i + 1] = (xo[i] & o) | uo[i];
  }
  c0e[0] = __shfl_sync(kFull, c0e[CPL], up, LANES);
  c0o[0] = __shfl_sync(kFull, c0o[CPL], up, LANES);
  c1e[0] = __shfl_sync(kFull, c1e[CPL], up, LANES);
  c1o[0] = __shfl_sync(kFull, c1o[CPL], up, LANES);
  c0e[CPL + 1] = __shfl_sync(kFull, c0e[1], dn, LANES);
  c0o[CPL + 1] = __shfl_sync(kFull, c0o[1], dn, LANES);
  c1e[CPL + 1] = __shfl_sync(kFull, c1e[1], dn, LANES);
  c1o[CPL + 1] = __shfl_sync(kFull, c1o[1], dn, LANES);
#pragma unroll
  for (int i = 0; i < CPL; ++i) {
    s.e[i] = rok(s.e[i], xe[i], ue[i], c0e[i], c1e[i], c0e[i + 2], c1e[i + 2]);
    s.o[i] = rok(s.o[i], xo[i], uo[i], c0o[i], c1o[i], c0o[i + 2], c1o[i + 2]);
  }
}

// Thread -> (board, segment lane, shuffle sources).  Threads past the last
// board step zeros and store nothing, so every warp shuffles with a full
// mask.
template <int CPL>
struct Place {
  int64_t board;
  int lane, up, dn;
  bool valid;
  __device__ Place(int64_t n_boards) {
    constexpr int LANES = 64 / CPL;
    int64_t t = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
    board = t / LANES;
    lane = int(t % LANES);
    up = (lane + LANES - 1) % LANES;
    dn = (lane + 1) % LANES;
    valid = board < n_boards;
  }
  __device__ int64_t offset() const { return board * 128 + lane * 2 * CPL; }
};

template <int CPL>
__global__ void __launch_bounds__(kBlock) rollout_kernel(
    const uint32_t* in, uint32_t* out, int64_t n_boards, int64_t steps) {
  Place<CPL> p(n_boards);
  Board<CPL> s;
  if (p.valid) load(in + p.offset(), s); else zero(s);
#pragma unroll 2
  for (int64_t t = 0; t < steps; ++t) step(s, p.up, p.dn);
  if (p.valid) store(out + p.offset(), s);
}

// MPC hard path: XOR generation t's toggles in, then step (the fused form
// of mpc/soft.hard_rollout).  toggles: uint32[T, B, 64, 2].
template <int CPL>
__global__ void __launch_bounds__(kBlock) controlled_kernel(
    const uint32_t* in, const uint32_t* toggles, uint32_t* out,
    int64_t n_boards, int64_t steps) {
  Place<CPL> p(n_boards);
  Board<CPL> s, g;
  if (p.valid) load(in + p.offset(), s); else zero(s);
  zero(g);
  for (int64_t t = 0; t < steps; ++t) {
    if (p.valid) load(toggles + t * n_boards * 128 + p.offset(), g);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      s.e[i] ^= g.e[i];
      s.o[i] ^= g.o[i];
    }
    step(s, p.up, p.dn);
  }
  if (p.valid) store(out + p.offset(), s);
}

// Catalyst search: step the placed boards and, beside each, the shared
// baseline reaction (``active``, uint32[64, 2]); OR into an accumulator
// every cell of the catalyst's zone of influence that differs from
// (baseline | placed catalyst) after each generation.  placed/zoi:
// uint32[B, 64, 2].  hit[b] is nonzero iff board b's catalyst was
// perturbed; base_out receives the baseline after the last generation
// (search.catalyst_search).
template <int CPL>
__global__ void __launch_bounds__(kBlock) catalyst_kernel(
    const uint32_t* in, const uint32_t* active, const uint32_t* placed,
    const uint32_t* zoi, uint32_t* out, uint32_t* hit, uint32_t* base_out,
    int64_t n_boards, int64_t steps) {
  constexpr int LANES = 64 / CPL;
  Place<CPL> p(n_boards);
  Board<CPL> s, pc, z, base;
  if (p.valid) {
    load(in + p.offset(), s);
    load(placed + p.offset(), pc);
    load(zoi + p.offset(), z);
  } else {
    zero(s);
    zero(pc);
    zero(z);
  }
  load(active + p.lane * 2 * CPL, base);
  uint32_t acc = 0u;
  for (int64_t t = 0; t < steps; ++t) {
    step(s, p.up, p.dn);
    step(base, p.up, p.dn);
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      acc |= (s.e[i] ^ (base.e[i] | pc.e[i])) & z.e[i];
      acc |= (s.o[i] ^ (base.o[i] | pc.o[i])) & z.o[i];
    }
  }
#pragma unroll
  for (int w = LANES / 2; w > 0; w /= 2) acc |= __shfl_xor_sync(kFull, acc, w, LANES);
  if (p.valid) {
    store(out + p.offset(), s);
    if (p.lane == 0) hit[p.board] = acc;
  }
  if (p.board == 0) store(base_out + p.lane * 2 * CPL, base);
}

ffi::Error check_boards(const ffi::Buffer<ffi::U32>& b, int rank) {
  auto d = b.dimensions();
  if (d.size() != size_t(rank) || d[rank - 2] != 64 || d[rank - 1] != 2) {
    return ffi::Error::InvalidArgument("expected uint32[..., 64, 2] boards");
  }
  return ffi::Error::Success();
}

ffi::Error launch_status() {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

// Columns per thread: 8 (eight threads per board) measured fastest of
// 2, 4, 8 and 16 on the H100, by under 8% (PERF.md).
constexpr int kCpl = 8;

int64_t grid_for(int64_t n_boards) {
  return (n_boards * (64 / kCpl) + kBlock - 1) / kBlock;
}

ffi::Error Rollout(cudaStream_t stream, ffi::Buffer<ffi::U32> boards,
                   ffi::ResultBuffer<ffi::U32> out, int64_t steps) {
  if (auto e = check_boards(boards, 3); e.failure()) return e;
  int64_t n = boards.dimensions()[0];
  if (n == 0) return ffi::Error::Success();
  rollout_kernel<kCpl><<<grid_for(n), kBlock, 0, stream>>>(
      boards.typed_data(), out->typed_data(), n, steps);
  return launch_status();
}

ffi::Error Controlled(cudaStream_t stream, ffi::Buffer<ffi::U32> boards,
                      ffi::Buffer<ffi::U32> toggles,
                      ffi::ResultBuffer<ffi::U32> out) {
  if (auto e = check_boards(boards, 3); e.failure()) return e;
  if (auto e = check_boards(toggles, 4); e.failure()) return e;
  int64_t n = boards.dimensions()[0];
  int64_t steps = toggles.dimensions()[0];
  if (toggles.dimensions()[1] != n) {
    return ffi::Error::InvalidArgument("toggles must be uint32[T, B, 64, 2]");
  }
  if (n == 0) return ffi::Error::Success();
  controlled_kernel<kCpl><<<grid_for(n), kBlock, 0, stream>>>(
      boards.typed_data(), toggles.typed_data(), out->typed_data(), n, steps);
  return launch_status();
}

ffi::Error Catalyst(cudaStream_t stream, ffi::Buffer<ffi::U32> boards,
                    ffi::Buffer<ffi::U32> active, ffi::Buffer<ffi::U32> placed,
                    ffi::Buffer<ffi::U32> zoi, ffi::ResultBuffer<ffi::U32> out,
                    ffi::ResultBuffer<ffi::U32> hit,
                    ffi::ResultBuffer<ffi::U32> base_out, int64_t steps) {
  for (auto* b : {&boards, &placed, &zoi}) {
    if (auto e = check_boards(*b, 3); e.failure()) return e;
  }
  if (auto e = check_boards(active, 2); e.failure()) return e;
  int64_t n = boards.dimensions()[0];
  if (placed.dimensions()[0] != n || zoi.dimensions()[0] != n) {
    return ffi::Error::InvalidArgument("placed/zoi must match the boards");
  }
  // at least one board's threads, so the baseline is written for P = 0
  catalyst_kernel<kCpl><<<grid_for(n > 0 ? n : 1), kBlock, 0, stream>>>(
      boards.typed_data(), active.typed_data(), placed.typed_data(),
      zoi.typed_data(), out->typed_data(), hit->typed_data(),
      base_out->typed_data(), n, steps);
  return launch_status();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(LifeRollout, Rollout,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("steps"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(LifeControlledRollout, Controlled,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>());

XLA_FFI_DEFINE_HANDLER_SYMBOL(LifeCatalystRollout, Catalyst,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Arg<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Ret<ffi::Buffer<ffi::U32>>()
                                  .Attr<int64_t>("steps"));
