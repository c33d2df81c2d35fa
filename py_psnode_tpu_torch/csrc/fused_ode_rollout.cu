// Forward rollout of the neural ODE in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_ode.py:_fwd_kernel (:125),
// launched by _forward (pallas_call at :307). It computes the same function,
// in float32 with float32 accumulation (no TF32, no tensor cores), without
// the TPU's grid, time blocking, dt == 0 padding or lanes; its bf16 compute
// mode (below) is the TPU kernel's precision="bfloat16". Per step t and
// batch row b, with the layer-1 stream s_de (the initial-state
// contribution and the event-adjusted z projection, lifted out of the loop):
//
//   f(x) = tail(elu(s_de[t,b] + x @ wx))
//   x1   = Euler / Midpoint / RK4-3/8 step of f from x_c with dt[t,b]
//   sol[t,b] = x1;  x_c = x1
//
// where tail applies n_tail - 1 Dense->ELU layers [h, h] and a last Dense
// [h, xd] without activation. n_tail (1..kMaxTail) and xd are runtime
// values: the no-encode dynamics run with n_tail = 3 and xd the state
// width, the direct-encode latent dynamics with n_tail = 1 and xd = h.
//
// The bf16 compute mode (the TPU kernel's _cast_ode :58 and _dot; the
// template flag kBf16 of instantiations of its own, every path): s_de
// arrives as bfloat16, widened to float32 (exact) as a step's rows are
// copied into shared memory, at once; the weights arrive as bfloat16 and
// pack_nets widens them into the padded float32 blocks (exact); every
// product rounds its activation operand to bf16 with __float2bfloat16_rn as
// it reads it and sums in float32. Biases, the carry, dt and the stage
// updates stay float32 (csrc/fused_dae_rollout.cu says what this simple
// mode leaves for later).
//
// Bound on an H100 SXM at the no-encode training shape (B=64, T=1001,
// h=128, xd=2, RK4): an evaluation of f costs 2 (xd h + 2 h^2 + h xd) =
// 66.6 kFLOP, four per step, so the rollout is 64 x 1000 x 4 x 66.6 k =
// 17 GFLOP: 0.25 ms at the card's 67 TFLOP/s of float32 on the CUDA
// cores (no product runs on the tensor cores). Its bytes (s_de in, 33 MB,
// the solution out) take 0.01 ms at 3.35 TB/s. So it is compute-bound on
// paper and latency-bound in practice: a step is a serial chain of 12
// dependent layers at RK4, and B=64 rows fill half the card's SMs with one
// block each.
//
// What the design does about the chain (csrc/noencode_bwd.cuh, forward
// section, shared with csrc/fused_dae_rollout.cu): a layer is one pass and
// one barrier; the narrow readout (the xd outputs) folds into the next
// stage's first layer in 4 warps, so an evaluation takes three barriers and
// an RK4 step 12 (the earlier kernel: 20, its weights by scalar loads from
// L2); with one row a block both hidden weights sit in registers (32 a
// thread each; [ne-fwd-slots], each solver), the first layer, the readout
// and the biases in shared memory, and cp.async brings step t+1's stream
// row and dt while step t runs. The encode shape (xd = h) keeps a wide readout with its own
// barrier. With more rows than SMs a block takes a tile of R rows that
// share each weight load from shared memory (R = 8 at B = 1024). The
// weights arrive as the wrapper holds them and pack_nets pads them on the
// card. Wider h runs as 128-wide chunks from L2, with fewer rows a block
// where R rows' buffers do not fit shared memory, and with one row's
// buffers in global memory where even those do not (h above about 3 000).
// Rows are independent: no atomics.

#include "noencode_bwd.cuh"

namespace {

// Where a block keeps the hidden weights; phase_clock's [ne-fwd-slots] sweep
// builds other placements with -D. NE_FWD_REGS: the hidden weights a
// folding block holds in registers (both). NE_FWD_SLOTS: at most this many
// in shared memory after them (-1: all that fit).
#ifndef NE_FWD_REGS
#define NE_FWD_REGS 2
#endif
#ifndef NE_FWD_SLOTS
#define NE_FWD_SLOTS -1
#endif
constexpr int kRegBanks = NE_FWD_REGS;
constexpr int kSlotCap = NE_FWD_SLOTS;

struct Args {
  const float* s_de;  // [tm1, batch, h]
  const float* dt;    // [tm1, batch]
  const float* x0;    // [batch, xd]
  Net de;             // first layer wx (kin = xd), out = xd
  float* sol;         // [tm1, batch, xd]
  float* gmem;        // the blocks' buffers in global memory (null: in shared memory)
  size_t gmem_block;  // floats of a block's buffers there
  int tm1, batch, h, H, xd, solver;
};

// Floats of one prefetched step of R rows: the stream rows, then dt of each
// row in 4 floats.
__host__ __device__ inline int step_floats(int R, int H) { return R * H + 4 * R; }

// The buffers of a block of R rows, in floats.
__host__ inline size_t smem_floats(int slots, const Net& de, int R, int H) {
  const size_t RH = static_cast<size_t>(R) * H;
  // resident weights, tables, activations (2), prefetched steps (2), the
  // readout, the next input, the carries (2), the stages (4)
  return static_cast<size_t>(slots) * kMat + fwd_net_floats(de, H) + 2 * RH +
         2 * static_cast<size_t>(step_floats(R, H)) + RH + RH + 6 * RH;
}

// kFoldPath: one row a block (R = 1) and a narrow net, the readout folded
// into the next first layer by the first kFoldWarps warps; else the tile
// path. NB: the hidden weights held in registers. kGlobal: the block's
// buffers in global memory (one row a block, the tile path), else in shared
// memory, which the compiler then addresses as such.
template <int R, bool kFoldPath, int NB, bool kGlobal, bool kBf16 = false>
__global__ void __launch_bounds__(kThreads, 1) ode_forward(const __grid_constant__ Args a, int slots) {
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.batch, h = a.h, xd = a.xd, S = n_stages(a.solver);
  const int tid = threadIdx.x, row0 = blockIdx.x * R, RH = R * H, SF = step_floats(R, H);
  constexpr bool async = !kGlobal;  // the step's rows by cp.async
  float* p = smem;
  if constexpr (kGlobal) p = a.gmem + blockIdx.x * a.gmem_block;
  float* wres = p;
  p += static_cast<size_t>(slots) * kMat;
  const FwdNet tde = carve_net(a.de, H, p);
  float* vec = p;  // every vector below starts at zero
  float* act_a = p;
  float* act_b = act_a + RH;
  float* pf = act_b + RH;   // [2][SF]
  float* y = pf + 2 * SF;   // [R][H] the readout
  float* xin = y + RH;      // [R][H] the next input
  float* xc = xin + RH;     // [2][R][H] the carry of even and odd steps
  float* kq = xc + 2 * RH;  // [4][R][H] the stages' derivatives
  for (int e = tid; e < kq + 4 * RH - vec; e += kThreads) vec[e] = 0.f;
  __syncthreads();
  float4 wr[NB > 0 ? NB : 1][8];  // hidden weights held in registers
  load_m16<NB>(a.de, wres, wr);
  load_tables(a.de, tde);
  for (int e = tid; e < R * xd; e += kThreads) {
    const int r = e / xd, c = e - r * xd, g = row0 + r;
    xc[r * H + c] = xin[r * H + c] = g < B ? __ldg(a.x0 + static_cast<size_t>(g) * xd + c) : 0.f;
  }

  // step t's stream rows and step sizes into buffer t & 1
  auto stream = [&](int) { return a.s_de; };
  auto stream_bf16 = [&](int) { return reinterpret_cast<const __nv_bfloat16*>(a.s_de); };
  const RowCopy rc = row_copy(1, R, h, H, row0, B, async && !kBf16, stream);
  const int ea = kThreads - 1 - tid;  // the threads from the top copy dt
  const float* dt_src = ea < R && row0 + ea < B ? a.dt + row0 + ea : nullptr;
  auto prefetch = [&](int t) {
    float* dst = pf + (t & 1) * SF;
    if constexpr (kBf16) {
      prefetch_rows_bf16(dst, t, 1, R, h, H, row0, B, stream_bf16);
    } else {
      prefetch_rows(rc, dst, t, 1, R, h, H, row0, B, a.dt, stream);
    }
    if (ea < R)
      step_copy(dst + RH + 4 * ea, dt_src ? dt_src + static_cast<size_t>(t) * B : a.dt, dt_src != nullptr, async);
    cp_async_commit();
  };
  auto s_de = [&](int t) { return pf + (t & 1) * SF; };
  auto dt_of = [&](int t, int r) { return pf[(t & 1) * SF + RH + 4 * r]; };
  auto other = [&](const float* q) { return q == act_a ? act_b : act_a; };
  auto sol_at = [&](int t, int r) { return a.sol + (static_cast<size_t>(t) * B + row0 + r) * xd; };

  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();
  float* cur = act_a;
  first_layer<R, kBf16>(a.de, tde, xin, s_de(0), cur);

  int par = 0;  // xc + par RH holds x_t
  for (int t = 0; t < a.tm1; ++t) {
    NE_FWD_START(t, a.tm1);
    if (t + 1 < a.tm1) prefetch(t + 1);  // into the buffer step t - 1 used
    const float* x_t = xc + par * RH;
    float* x_n = xc + (par ^ 1) * RH;
    const bool more = t + 1 < a.tm1;
    NE_FWD_MARK(0);
    for (int q = 0; q < S; ++q) {
      const bool last = q + 1 == S;
      // at the last stage, step t + 1's rows land before the readout's barrier
      cur = fwd_hidden<R, NB, kBf16>(a.de, tde, cur, other(cur), wres, wr, last);
      if (last && a.de.n == 1) {
        cp_async_wait<0>();
        __syncthreads();
      }
      NE_FWD_MARK(3 + 3 * q);
      float* nxt = other(cur);
      // the next first layer: stage q + 1 of this step, or stage 1 of the next
      const float* s_next = last ? s_de(t + 1) : s_de(t);
      if constexpr (kFoldPath) {
        if (tid < 32 * kFoldWarps) {
          float yr[kFold], in[kFold];
          fold_readout<kBf16>(a.de, tde, cur, yr);
          NE_FWD_MARK(4 + 3 * q);
          const float dt = dt_of(t, 0);
#pragma unroll
          for (int c = 0; c < kFold; ++c) {
            in[c] = 0.f;
            if (c < xd) {  // stage q + 1's input, or x_{t+1} at the last stage
              in[c] = stage_next(a.solver, q, x_t[c], dt, yr[c], [&](int i) { return kq[i * H + c]; });
              if (tid == c) {
                if (!last) {
                  kq[q * H + c] = yr[c];
                } else {
                  x_n[c] = in[c];
                  sol_at(t, 0)[c] = in[c];
                }
              }
            }
          }
          NE_FWD_MARK(14);
          if (!last || more) fold_first_layer<kBf16>(a.de, tde, in, s_next, nxt);
        }
        __syncthreads();
      } else {
        tile_readout<R, kBf16>(a.de, tde, cur, y);
        NE_FWD_MARK(4 + 3 * q);
        for (int e = tid; e < R * xd; e += kThreads) {
          const int r = e / xd, c = e - r * xd, o = r * H + c;
          const float v = y[o];
          const float xn = stage_next(a.solver, q, x_t[o], dt_of(t, r), v, [&](int i) { return kq[i * RH + o]; });
          xin[o] = xn;
          if (!last) {
            kq[q * RH + o] = v;
          } else {
            x_n[o] = xn;
            if (row0 + r < B) sol_at(t, r)[c] = xn;
          }
        }
        __syncthreads();
        NE_FWD_MARK(14);
        if (!last || more) first_layer<R, kBf16>(a.de, tde, xin, s_next, nxt);
      }
      cur = nxt;
      NE_FWD_MARK(last ? 16 : 2 + 3 * (q + 1));
    }
    par ^= 1;
  }
}

template <int R, bool kFoldPath, int NB, bool kGlobal = false, bool kBf16 = false>
cudaError_t launch(Args b, cudaStream_t st) {
  Net* nets[1] = {&b.de};
  // by default, one row a block: the two hidden weights in registers; a
  // tile of rows: in shared memory
  // (phase_clock's [ne-fwd-slots] sweep); buffers in global memory: through
  // L1 and L2
  const int cap = kGlobal ? 0 : (kSlotCap >= 0 ? kSlotCap : kMaxTail);
  const int slots = fwd_place(nets, 1, b.H, NB, cap, smem_floats(0, b.de, R, b.H));
  const size_t smem = kGlobal ? 0 : smem_floats(slots, b.de, R, b.H) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(ode_forward<R, kFoldPath, NB, kGlobal, kBf16>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (b.batch + R - 1) / R;
  ode_forward<R, kFoldPath, NB, kGlobal, kBf16><<<blocks, kThreads, smem, st>>>(b, slots);
  return cudaGetLastError();
}

// A call's plan: its net, its padded block at the front of the scratch
// (weights then biases; null scratch: the shape alone), its padded width,
// its rows a block, and the scratch's floats (the padded weights, then,
// where a block's buffers do not fit shared memory, every block's buffers).
struct Plan {
  Net de;
  int H;
  FwdShape shape;
  size_t weights, scratch;
};

bool plan(Plan& p, int batch, int h, int xd, int n_tail, int rows, float* scratch) {
  if (batch < 1 || h < 1 || xd < 1 || n_tail < 1 || n_tail > kMaxTail ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8))
    return false;
  p.H = fwd_width(h > xd ? h : xd);
  const size_t wd = (n_tail + 1) * static_cast<size_t>(p.H) * p.H;
  p.de = make_net(scratch, scratch ? scratch + wd : nullptr, n_tail, xd, xd, p.H);
  p.weights = wd + static_cast<size_t>(n_tail) * p.H;
  p.shape = fwd_shape(rows, [&](int R) { return smem_floats(0, p.de, R, p.H); });
  const size_t blocks = (batch + p.shape.rows - 1) / p.shape.rows;
  p.scratch = p.weights + (p.shape.gmem ? blocks * p.shape.floats : 0);
  return true;
}

// A launch of these sizes: the weights packed, then the rollout (the bf16
// mode where bf16).
int rollout(const void* s_de, const void* dt, const void* x0, const void* wx, const void* const* w,
            const void* const* b, int n_tail, void* scratch, void* sol, int tm1, int batch, int h, int xd,
            int solver, int rows_per_block, bool bf16, void* stream) {
  Plan p;
  float* base = static_cast<float*>(scratch);
  if (tm1 < 0 || solver < 0 || solver > 2 || !base || !plan(p, batch, h, xd, n_tail, rows_per_block, base))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tm1 == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PackArgs pk{};
  pk.src[0].w0[0] = pk.src[0].w0[1] = wx;
  pk.src[0].k0[0] = xd;
  for (int l = 0; l < n_tail; ++l) {
    pk.src[0].w[l] = w[l];
    pk.src[0].b[l] = static_cast<const float*>(b[l]);
  }
  pk.dst[0] = p.de;
  pk.count = 1;
  pk.h = h;
  pk.H = p.H;
  const int pb = pack_blocks(p.weights);
  if (bf16) {
    pack_nets<__nv_bfloat16><<<pb, kThreads, 0, st>>>(pk);
  } else {
    pack_nets<float><<<pb, kThreads, 0, st>>>(pk);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.dt = static_cast<const float*>(dt);
  a.x0 = static_cast<const float*>(x0);
  a.de = p.de;
  a.sol = static_cast<float*>(sol);
  a.gmem = p.shape.gmem ? base + p.weights : nullptr;
  a.gmem_block = p.shape.floats;
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.H = p.H;
  a.xd = xd;
  a.solver = solver;
  if (bf16) {
    if (p.shape.gmem) return static_cast<int>(launch<1, false, 0, true, true>(a, st));
    switch (p.shape.rows) {
      case 1:
        return static_cast<int>(narrow_in(a.de) && narrow_out(a.de) ? launch<1, true, kRegBanks, false, true>(a, st)
                                                                    : launch<1, false, 0, false, true>(a, st));
      case 2: return static_cast<int>(launch<2, false, 0, false, true>(a, st));
      case 4: return static_cast<int>(launch<4, false, 0, false, true>(a, st));
      default: return static_cast<int>(launch<8, false, 0, false, true>(a, st));
    }
  }
  if (p.shape.gmem) return static_cast<int>(launch<1, false, 0, true>(a, st));
  switch (p.shape.rows) {
    case 1:
      return static_cast<int>(narrow_in(a.de) && narrow_out(a.de) ? launch<1, true, kRegBanks>(a, st)
                                                                  : launch<1, false, 0>(a, st));
    case 2: return static_cast<int>(launch<2, false, 0>(a, st));
    case 4: return static_cast<int>(launch<4, false, 0>(a, st));
    default: return static_cast<int>(launch<8, false, 0>(a, st));
  }
}

}  // namespace

// C interface, loaded with ctypes. psn_fused_ode_rollout_scratch: the floats
// of device scratch a launch of these sizes needs (-1: sizes it refuses).
// psn_fused_ode_rollout_f32: pointers are device pointers to contiguous
// float32 arrays in the wrapper's layout (row = input): wx [xd][h]; w / b
// host arrays of the tail layers' weights [in][out] and biases [out];
// scratch of psn_fused_ode_rollout_scratch floats. solver: 0 Euler, 1
// Midpoint, 2 RK4 (3/8 rule). rows_per_block: 1, 2, 4 or 8, the most rows
// a block takes (fewer where their buffers do not fit shared memory).
// Launches on `stream` without synchronising and returns the launches'
// error (0 on success). psn_fused_ode_rollout_bf16: the bf16 compute mode,
// the same arguments with s_de, wx and the tail weights w bfloat16 arrays
// (the biases, dt and x0 float32).
extern "C" long long psn_fused_ode_rollout_scratch(int batch, int h, int xd, int n_tail, int rows_per_block) {
  Plan p;
  return plan(p, batch, h, xd, n_tail, rows_per_block, nullptr) ? static_cast<long long>(p.scratch) : -1;
}

extern "C" int psn_fused_ode_rollout_f32(const void* s_de, const void* dt, const void* x0, const void* wx,
                                         const void* const* w, const void* const* b, int n_tail, void* scratch,
                                         void* sol, int tm1, int batch, int h, int xd, int solver,
                                         int rows_per_block, void* stream) {
  return rollout(s_de, dt, x0, wx, w, b, n_tail, scratch, sol, tm1, batch, h, xd, solver, rows_per_block, false,
                 stream);
}

extern "C" int psn_fused_ode_rollout_bf16(const void* s_de, const void* dt, const void* x0, const void* wx,
                                          const void* const* w, const void* const* b, int n_tail, void* scratch,
                                          void* sol, int tm1, int batch, int h, int xd, int solver,
                                          int rows_per_block, void* stream) {
  return rollout(s_de, dt, x0, wx, w, b, n_tail, scratch, sol, tm1, batch, h, xd, solver, rows_per_block, true,
                 stream);
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
