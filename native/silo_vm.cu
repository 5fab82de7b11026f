// Filter-VM kernel for NVIDIA Hopper (sm_90a), called from JAX through the
// XLA foreign function interface (lapis_silo_tpu/ops/vm_kernel.py builds
// and registers it).
//
// Executes the register-machine instruction stream of ops/vm.py over the
// flat global word axis. Semantics are exactly those of the XLA interpreter
// (vm.build_run_one_with_emit): every instruction computes
//     reg[dst] = mode(reg[ra], b)       b = one of six sources
// and writes it unless dst >= n_regs; EMIT_COUNT adds popcount(reg[ra])
// into counts[operand].
//
// Layout of the work:
// - grid.x tiles the word axis: a block owns kTileWords words, each thread
//   four adjacent words (one 16-byte vector), in EVERY register. A thread
//   therefore only ever touches its own columns of the register file, so
//   no instruction needs a barrier.
// - grid.y splits the batch: block row c runs instructions
//   [bounds[c], bounds[c+1]). The Python wrapper puts every bound on a
//   query boundary, and a lowered query writes each register before it
//   reads it, so the rows are independent.
// - The register file lives in shared memory, n_regs x kThreads x 16 B.
// - The b-source rows of the next kPrefetch instructions are loaded ahead
//   into registers; the instruction stream itself is read with uniform
//   loads (every thread of the block reads the same address).
// - EMIT_COUNT reduces within the warp and adds with one integer atomicAdd
//   per warp: exact in any order.
// - Block row n_chunks-1 holds the last query; it writes reg[0] to words.

#include <cstdint>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 128;
constexpr int kTileWords = 4 * kThreads;
constexpr int kPrefetch = 4;

// Wire layout of the packed instruction word (ops/vm.py pack_wire).
constexpr int kDstMask = 0x3F;
constexpr int kRaShift = 6;
constexpr int kRbShift = 12;
constexpr int kModeShift = 18;
constexpr int kBsrcShift = 22;
constexpr int kOpShift = 26;
constexpr int kEmitCount = 1;

struct VmArgs {
  const int32_t* operands;
  const int32_t* packed;
  const int32_t* bounds;
  int32_t n_chunks;
  const uint32_t* bank;
  int64_t n_bank;
  const uint32_t* dyn;
  int64_t n_dyn;
  const uint32_t* sparse;
  int64_t n_sparse;
  const uint32_t* full;
  int64_t pw;
  int32_t n_regs;
  int32_t n_counts;
  uint32_t* words;
  int32_t* counts;
};

__device__ __forceinline__ uint4 load4(const uint32_t* row, int64_t w) {
  return __ldg(reinterpret_cast<const uint4*>(row + w));
}

__device__ __forceinline__ uint4 and4(uint4 x, uint4 y) {
  return make_uint4(x.x & y.x, x.y & y.y, x.z & y.z, x.w & y.w);
}

__device__ __forceinline__ uint4 or4(uint4 x, uint4 y) {
  return make_uint4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
}

__device__ __forceinline__ uint4 xor4(uint4 x, uint4 y) {
  return make_uint4(x.x ^ y.x, x.y ^ y.y, x.z ^ y.z, x.w ^ y.w);
}

__device__ __forceinline__ int64_t clamp_row(int32_t op, int64_t n) {
  return op < 0 ? 0 : (op >= n ? n - 1 : op);
}

// The instruction's b-source words, for every source held in device
// memory (bank, dyn, sparse, full); zero for B_REG (read at execution) and
// B_ZERO.
__device__ __forceinline__ uint4 fetch_b(const VmArgs& a, int i, int64_t w,
                                         bool live) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (!live) return zero;
  const int32_t op = a.operands[i];
  switch ((a.packed[i] >> kBsrcShift) & 0xF) {
    case 1:
      return load4(a.bank + clamp_row(op, a.n_bank) * a.pw, w);
    case 2:
      return load4(a.dyn + clamp_row(op, a.n_dyn) * a.pw, w);
    case 3:
      return load4(a.sparse + clamp_row(op, a.n_sparse) * a.pw, w);
    case 4:
      return load4(a.full, w);
    default:
      return zero;
  }
}

__device__ __forceinline__ void step(const VmArgs& a, uint4* regs, int i,
                                     uint4 b, uint4 full, int tid) {
  const int32_t spec = a.packed[i];
  const int32_t op = a.operands[i];
  const int last = a.n_regs - 1;
  const int dst = spec & kDstMask;
  const int ra = min((spec >> kRaShift) & 0x3F, last);
  const int rb = min((spec >> kRbShift) & 0x3F, last);
  const int mode = (spec >> kModeShift) & 0xF;
  const int bsrc = (spec >> kBsrcShift) & 0xF;
  const uint4 av = regs[ra * kThreads + tid];
  if (bsrc == 0) b = regs[rb * kThreads + tid];
  uint4 v;
  switch (mode) {
    case 0:
      v = b;
      break;
    case 1:
      v = and4(av, b);
      break;
    case 2:
      v = or4(av, b);
      break;
    case 3:
      v = xor4(av, b);
      break;
    default:
      v = and4(av, xor4(b, full));
      break;
  }
  if (dst < a.n_regs) regs[dst * kThreads + tid] = v;
  if (((spec >> kOpShift) & 0x3) == kEmitCount && op >= 0 &&
      op < a.n_counts) {
    int cnt = __popc(av.x) + __popc(av.y) + __popc(av.z) + __popc(av.w);
    for (int o = 16; o > 0; o >>= 1) cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if ((tid & 31) == 0 && cnt != 0) atomicAdd(a.counts + op, cnt);
  }
}

__global__ void __launch_bounds__(kThreads) vm_kernel(VmArgs a) {
  extern __shared__ uint4 regs[];  // [n_regs][kThreads]
  const int tid = threadIdx.x;
  const int64_t w = (static_cast<int64_t>(blockIdx.x) * kThreads + tid) * 4;
  const bool live = w < a.pw;
  const int c = blockIdx.y;
  const int start = a.bounds[c];
  const int end = a.bounds[c + 1];
  const bool writes_words = c == a.n_chunks - 1;
  if (start >= end && !writes_words) return;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int r = 0; r < a.n_regs; ++r) regs[r * kThreads + tid] = zero;
  const uint4 full = live ? load4(a.full, w) : zero;

  uint4 pf[kPrefetch];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j)
    pf[j] = start + j < end ? fetch_b(a, start + j, w, live) : zero;
  for (int i = start; i < end; i += kPrefetch) {
#pragma unroll
    for (int j = 0; j < kPrefetch; ++j) {
      const int ii = i + j;
      if (ii < end) {
        const uint4 b = pf[j];
        if (ii + kPrefetch < end) pf[j] = fetch_b(a, ii + kPrefetch, w, live);
        step(a, regs, ii, b, full, tid);
      }
    }
  }
  if (writes_words && live)
    *reinterpret_cast<uint4*>(a.words + w) = regs[tid];
}

ffi::Error VmRun(cudaStream_t stream, ffi::Buffer<ffi::S32> operands,
                 ffi::Buffer<ffi::S32> packed, ffi::Buffer<ffi::S32> bounds,
                 ffi::Buffer<ffi::U32> bank, ffi::Buffer<ffi::U32> dyn,
                 ffi::Buffer<ffi::U32> sparse, ffi::Buffer<ffi::U32> full,
                 ffi::ResultBuffer<ffi::U32> words,
                 ffi::ResultBuffer<ffi::S32> counts, int32_t n_regs) {
  const int64_t pw = static_cast<int64_t>(full.element_count());
  if (pw <= 0 || pw % 4 != 0)
    return ffi::Error::InvalidArgument("word axis must be a positive multiple of 4");
  if (n_regs < 1 || n_regs > 64)
    return ffi::Error::InvalidArgument("n_regs out of range");
  if (operands.element_count() != packed.element_count() ||
      bounds.element_count() < 2)
    return ffi::Error::InvalidArgument("malformed instruction stream");
  VmArgs a;
  a.operands = operands.typed_data();
  a.packed = packed.typed_data();
  a.bounds = bounds.typed_data();
  a.n_chunks = static_cast<int32_t>(bounds.element_count() - 1);
  a.bank = bank.typed_data();
  a.n_bank = static_cast<int64_t>(bank.element_count()) / pw;
  a.dyn = dyn.typed_data();
  a.n_dyn = static_cast<int64_t>(dyn.element_count()) / pw;
  a.sparse = sparse.typed_data();
  a.n_sparse = static_cast<int64_t>(sparse.element_count()) / pw;
  a.full = full.typed_data();
  a.pw = pw;
  a.n_regs = n_regs;
  a.n_counts = static_cast<int32_t>(counts->element_count());
  a.words = words->typed_data();
  a.counts = counts->typed_data();
  if (a.n_bank < 1 || a.n_dyn < 1 || a.n_sparse < 1)
    return ffi::Error::InvalidArgument("empty source array");

  cudaError_t err = cudaMemsetAsync(a.counts, 0,
                                    sizeof(int32_t) * a.n_counts, stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  const size_t smem = sizeof(uint4) * kThreads * static_cast<size_t>(n_regs);
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(vm_kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  const dim3 grid(static_cast<unsigned>((pw + kTileWords - 1) / kTileWords),
                  static_cast<unsigned>(a.n_chunks));
  void* args[] = {&a};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(vm_kernel), grid,
                         dim3(kThreads), args, smem, stream);
  if (err != cudaSuccess) return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(SiloVmRun, VmRun,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()  // operands
                                  .Arg<ffi::Buffer<ffi::S32>>()  // packed
                                  .Arg<ffi::Buffer<ffi::S32>>()  // bounds
                                  .Arg<ffi::Buffer<ffi::U32>>()  // bank
                                  .Arg<ffi::Buffer<ffi::U32>>()  // dyn
                                  .Arg<ffi::Buffer<ffi::U32>>()  // sparse
                                  .Arg<ffi::Buffer<ffi::U32>>()  // full
                                  .Ret<ffi::Buffer<ffi::U32>>()  // words
                                  .Ret<ffi::Buffer<ffi::S32>>()  // counts
                                  .Attr<int32_t>("n_regs"));
