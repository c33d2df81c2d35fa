// Forward rollout of the semi-explicit neural DAE in one launch.
//
// Replaces the TPU kernel py_psnode_tpu/ops/fused_dae.py:_kernel (:371),
// launched by fused_dae_rollout_packed (pallas_call at :588). It computes
// the same function, in float32 with float32 accumulation (no TF32, no
// tensor cores), without the TPU's grid, time blocking, lanes or bf16
// mode. Per step t and batch row b:
//
//   i_in = ev[t,b] > 0 ? AE(x_c, s_ae_ev[t]) : i_c      (event recompute)
//   f(x) = DE_tail(s_de[t] + x @ wx_de + i_in @ wi_de)
//   x1   = Euler / Midpoint / RK4-3/8 step of f from x_s with dt[t,b]
//   i1   = AE(x_a, s_ae[t]),  AE(x, s) = AE_tail(s + x @ gx_ae)
//   sol[t,b] = cat(x1, i1);  x_c, i_c = x1, i1
//
// where *_tail applies ELU to the lifted first layer, then Dense->ELU
// layers and a last Dense without activation; x_s = x_c and x_a = x1, or
// in the TF-x mode (teacher forcing of x, the TPU kernel's tf_x) the true
// states x_s = x_true[t] and x_a = x_true[t+1], while the event recompute
// still reads the rolled carry x_c. The TF-x mode is a template flag of its
// own instantiations: it runs the tile path (its true rows come with each
// step's cp.async prefetch, and the folded readouts, which carry x1 from
// the last stage into the AE and on into the next step, are not taken);
// the other instantiations compile as without it.
//
// Bound on an H100 SXM at the motor training shape (B=64, T=1001, h=128,
// xd=3, id=2, three-layer tails, RK4): a row-step evaluates the DE four
// times and the AE once, two 128 x 128 layers each, 3.4e5 FLOP, so the
// rollout is 2.1e10 FLOP: 0.32 ms at the card's 67 TFLOP/s of float32 on
// the CUDA cores (no product runs on the tensor cores). The three h-wide
// streams are 98 MB of reads, 0.03 ms at 3.35 TB/s. So the kernel is
// compute-bound on paper and latency-bound in practice: a step is a serial
// chain of 15 dependent 128-wide layers at RK4, and B=64 rows fill half the
// card's 132 SMs with one block each.
//
// What the design does about the chain (csrc/noencode_bwd.cuh, forward
// section): a layer is one pass and one barrier (the earlier kernel took a
// separate ELU pass, about 30 barriers an RK4 step, and read every weight
// by scalar loads from L2, 3 700 cycles a hidden layer: phase_clock's
// [ne-fwd-split]); the narrow readouts (the DE's xd outputs, the AE's id)
// fold into the next evaluation's first layer in 4 warps, so an
// evaluation takes three barriers and an RK4 step 15; with one row a block
// all four hidden weights stay on chip, the DE's first in registers, its
// second and the AE's in shared memory (a second in registers makes the
// kernel spill; [ne-fwd-slots]); the first layers, the readouts and the
// biases sit in shared memory for the whole launch, and cp.async brings
// step t+1's stream rows and (dt, ev) while step t runs. With more rows
// than SMs a block takes a tile of R rows that share each weight load (the
// DE's in shared memory, the AE's from L2; R = 8 at B = 1024, chip_smoke.py
// --sweep). The weights arrive as the wrapper holds them and pack_nets pads
// them on the card. Wider h runs as 128-wide chunks with its weights from
// L2, with fewer rows a block where R rows' buffers do not fit shared
// memory, and with one row's buffers in global memory where even those do
// not (h above about 1 400). Rows are independent: no atomics, the same
// bits on every launch.

#include "noencode_bwd.cuh"

namespace {

// Where a block keeps the hidden weights; phase_clock's [ne-fwd-slots] sweep
// builds other placements with -D. NE_FWD_REGS: the DE's hidden weights a
// folding block holds in registers (one; with two the kernel spills).
// NE_FWD_SLOTS: at most this many hidden weights in shared memory after
// them, the DE's then the AE's (-1: with one row a block all that fit, with
// a tile the DE's).
#ifndef NE_FWD_REGS
#define NE_FWD_REGS 1
#endif
#ifndef NE_FWD_SLOTS
#define NE_FWD_SLOTS -1
#endif
constexpr int kRegBanks = NE_FWD_REGS;
constexpr int kSlotCap = NE_FWD_SLOTS;

struct Args {
  const float* s_de;     // [tm1, batch, h]
  const float* s_ae;     // [tm1, batch, h]
  const float* s_ae_ev;  // [tm1, batch, h]
  const float* aux;      // [tm1, batch, 2]: (dt, ev)
  const float* x0;       // [batch, xd]
  const float* i0;       // [batch, id]
  Net de;                // first layer [wx_de; wi_de] (kin = xd + id), out = xd
  Net ae;                // first layer gx_ae (kin = xd), out = id
  float* sol;            // [tm1, batch, xd + id]
  float* gmem;           // the blocks' buffers in global memory (null: in shared memory)
  size_t gmem_block;     // floats of a block's buffers there
  int tm1, batch, h, H, xd, id, solver;
  const float* xt;       // the TF-x mode: x_true[:-1] [tm1, batch, xd]
  const float* xt1;      // and x_true[1:]
};

// A true row's floats in a step buffer: xd rounded up to a multiple of 4
// (0 without teacher forcing).
__host__ __device__ inline int tf_stride(int xd) { return (xd + 3) / 4 * 4; }

// Floats of one prefetched step of R rows: the three stream rows, then
// (dt, ev) of each row in 4 floats, then in the TF-x mode the rows'
// x_true[t] and x_true[t+1], X floats each.
__host__ __device__ inline int step_floats(int R, int H, int X = 0) { return 3 * R * H + 4 * R + 2 * R * X; }

// The buffers of a block of R rows, in floats (X: tf_stride in the TF-x
// mode, else 0).
__host__ inline size_t smem_floats(int slots, const Net& de, const Net& ae, int R, int H, int X = 0) {
  const size_t RH = static_cast<size_t>(R) * H;
  // resident weights, tables, activations (2), prefetched steps (2), the
  // readout, the inputs (DE, AE), the carries x (2), the stages (4), i_c, i_in
  return static_cast<size_t>(slots) * kMat + fwd_net_floats(de, H) + fwd_net_floats(ae, H) + 2 * RH +
         2 * static_cast<size_t>(step_floats(R, H, X)) + RH + 2 * RH + 8 * RH;
}

// kFoldPath: one row a block (R = 1) and narrow nets, the readouts folded
// into the next first layer by the first kFoldWarps warps; else the tile
// path. kGlobal: the block's buffers in global memory (one row a block, the
// tile path), else in shared memory, which the compiler then addresses as
// such. kTfx: the TF-x mode (the tile path).
template <int R, bool kFoldPath, bool kGlobal, bool kTfx = false>
__global__ void __launch_bounds__(kThreads, 1) dae_forward(const __grid_constant__ Args a, int slots) {
  static_assert(!(kTfx && kFoldPath), "the TF-x mode runs the tile path");
  extern __shared__ __align__(16) float smem[];
  const int H = a.H, B = a.batch, h = a.h, xd = a.xd, id = a.id, S = n_stages(a.solver);
  const int X = kTfx ? tf_stride(xd) : 0;
  const int tid = threadIdx.x, row0 = blockIdx.x * R, RH = R * H, SF = step_floats(R, H, X);
  const bool folder = tid < 32 * kFoldWarps;  // a warp that folds
  constexpr bool async = !kGlobal;            // the step's rows by cp.async
  float* p = smem;
  if constexpr (kGlobal) p = a.gmem + blockIdx.x * a.gmem_block;
  float* wres = p;
  p += static_cast<size_t>(slots) * kMat;
  const FwdNet tde = carve_net(a.de, H, p);
  const FwdNet tae = carve_net(a.ae, H, p);
  float* vec = p;  // every vector below starts at zero
  float* act_a = p;
  float* act_b = act_a + RH;
  float* pf = act_b + RH;   // [2][SF]
  float* y = pf + 2 * SF;   // [R][H] the readout
  float* xde = y + RH;      // [R][H] the DE's next input (x, i_in)
  float* xae = xde + RH;    // [R][H] the AE's next input
  float* xc = xae + RH;     // [2][R][H] the x carry of even and odd steps
  float* kq = xc + 2 * RH;  // [4][R][H] the stages' derivatives
  float* ic = kq + 4 * RH;  // [R][H] the i carry
  float* iin = ic + RH;     // [R][H] the step's i_in
  for (int e = tid; e < iin + RH - vec; e += kThreads) vec[e] = 0.f;
  __syncthreads();
  constexpr int NB = kFoldPath ? kRegBanks : 0;  // the register banks this kernel uses
  float4 wr[NB > 0 ? NB : 1][8];                 // the DE's hidden weights held in registers
  load_m16<NB>(a.de, wres, wr);
  load_m16<NB>(a.ae, wres, wr);
  load_tables(a.de, tde);
  load_tables(a.ae, tae);
  for (int e = tid; e < R * xd; e += kThreads) {
    const int r = e / xd, c = e - r * xd, g = row0 + r;
    xc[r * H + c] = g < B ? __ldg(a.x0 + static_cast<size_t>(g) * xd + c) : 0.f;
  }
  for (int e = tid; e < R * id; e += kThreads) {
    const int r = e / id, c = e - r * id, g = row0 + r;
    ic[r * H + c] = g < B ? __ldg(a.i0 + static_cast<size_t>(g) * id + c) : 0.f;
  }

  // step t's stream rows and (dt, ev) into buffer t & 1
  auto stream = [&](int q) { return q == 0 ? a.s_de : (q == 1 ? a.s_ae : a.s_ae_ev); };
  const RowCopy rc = row_copy(3, R, h, H, row0, B, async, stream);
  const int ea = kThreads - 1 - tid;  // the threads from the top copy (dt, ev)
  const float* aux_src = ea < 2 * R && row0 + (ea >> 1) < B ? a.aux + (row0 + (ea >> 1)) * 2 + (ea & 1) : nullptr;
  auto prefetch = [&](int t) {
    float* dst = pf + (t & 1) * SF;
    prefetch_rows(rc, dst, t, 3, R, h, H, row0, B, a.aux, stream);
    if (ea < 2 * R)
      step_copy(dst + 3 * RH + 4 * (ea >> 1) + (ea & 1),
                aux_src ? aux_src + static_cast<size_t>(t) * B * 2 : a.aux, aux_src != nullptr, async);
    if constexpr (kTfx) {  // the rows' x_true[t], then their x_true[t+1]
      const size_t step = static_cast<size_t>(t) * B * xd;
      for (int e = tid; e < 2 * R * xd; e += kThreads) {
        const int w = e / (R * xd), rest = e - w * R * xd, r = rest / xd, c = rest - r * xd;
        const bool ok = row0 + r < B;
        const float* src = (w == 0 ? a.xt : a.xt1) + step + static_cast<size_t>(row0 + r) * xd + c;
        step_copy(dst + 3 * RH + 4 * R + (w * R + r) * X + c, ok ? src : a.aux, ok, async);
      }
    }
    cp_async_commit();
  };
  auto s_de = [&](int t) { return pf + (t & 1) * SF; };
  auto s_ae = [&](int t) { return pf + (t & 1) * SF + RH; };
  auto s_ev = [&](int t) { return pf + (t & 1) * SF + 2 * RH; };
  auto dt_of = [&](int t, int r) { return pf[(t & 1) * SF + 3 * RH + 4 * r]; };
  auto ev_of = [&](int t, int r) { return pf[(t & 1) * SF + 3 * RH + 4 * r + 1] > 0.f; };
  // x_true[t] (w = 0) or x_true[t+1] (w = 1) of row r, column c (TF-x)
  auto x_true = [&](int t, int w, int r, int c) { return pf[(t & 1) * SF + 3 * RH + 4 * R + (w * R + r) * X + c]; };
  auto any_ev = [&](int t) {  // the same in every thread: one branch for the block
    bool v = false;
    for (int r = 0; r < R; ++r) v = v || ev_of(t, r);
    return v;
  };
  auto other = [&](const float* q) { return q == act_a ? act_b : act_a; };
  auto sol_at = [&](int t, int r) { return a.sol + (static_cast<size_t>(t) * B + row0 + r) * (xd + id); };

  prefetch(0);
  cp_async_wait<0>();
  __syncthreads();
  // the first evaluation's input: (x0, i0) for the DE (x_true[0] in the
  // TF-x mode), x0 for the AE at an event
  for (int e = tid; e < R * xd; e += kThreads) {
    const int r = e / xd, c = e - r * xd;
    xae[r * H + c] = xc[r * H + c];
    xde[r * H + c] = kTfx ? x_true(0, 0, r, c) : xc[r * H + c];
  }
  for (int e = tid; e < R * id; e += kThreads) {
    const int r = e / id, c = e - r * id;
    xde[r * H + xd + c] = iin[r * H + c] = ic[r * H + c];
  }
  __syncthreads();
  float* cur = act_a;
  if (any_ev(0)) {
    first_layer<R>(a.ae, tae, xae, s_ev(0), cur);
  } else {
    first_layer<R>(a.de, tde, xde, s_de(0), cur);
  }

  int par = 0;  // xc + par RH holds x_t
  for (int t = 0; t < a.tm1; ++t) {
    NE_FWD_START(t, a.tm1);
    if (t + 1 < a.tm1) prefetch(t + 1);  // into the buffer step t - 1 used
    float* x_t = xc + par * RH;
    float* x_n = xc + (par ^ 1) * RH;
    NE_FWD_MARK(0);

    // ---- the AE at the event: i_in of the event rows ----
    if (any_ev(t)) {
      cur = fwd_hidden<R, NB>(a.ae, tae, cur, other(cur), wres, wr, false);
      float* nxt = other(cur);
      if constexpr (kFoldPath) {
        if (folder) {
          float yr[kFold], in[kFold];
          fold_readout(a.ae, tae, cur, yr);
#pragma unroll
          for (int c = 0; c < kFold; ++c) {
            in[c] = c < xd ? x_t[c] : pick(yr, c - xd);
            if (tid == c && c < id) iin[c] = yr[c];
          }
          fold_first_layer(a.de, tde, in, s_de(t), nxt);
        }
        __syncthreads();
      } else {
        tile_readout<R>(a.ae, tae, cur, y);
        for (int e = tid; e < R * id; e += kThreads) {
          const int r = e / id, c = e - r * id;
          if (ev_of(t, r)) xde[r * H + xd + c] = iin[r * H + c] = y[r * H + c];
        }
        __syncthreads();
        first_layer<R>(a.de, tde, xde, s_de(t), nxt);
      }
      cur = nxt;
    }
    NE_FWD_MARK(1);

    // ---- the DE stages; the last one's fold starts the AE at t+1 ----
    for (int q = 0; q < S; ++q) {
      const bool last = q + 1 == S;
      cur = fwd_hidden<R, NB>(a.de, tde, cur, other(cur), wres, wr, false);
      NE_FWD_MARK(3 + 3 * q);
      float* nxt = other(cur);
      if constexpr (kFoldPath) {
        if (folder) {
          float yr[kFold], in[kFold];
          fold_readout(a.de, tde, cur, yr);
          NE_FWD_MARK(4 + 3 * q);
          const float dt = dt_of(t, 0);
#pragma unroll
          for (int c = 0; c < kFold; ++c) {
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
            } else {
              in[c] = last ? 0.f : iin[c - xd];
            }
          }
          NE_FWD_MARK(14);
          if (last) {
            fold_first_layer(a.ae, tae, in, s_ae(t), nxt);
          } else {
            fold_first_layer(a.de, tde, in, s_de(t), nxt);
          }
        }
        __syncthreads();
      } else {
        tile_readout<R>(a.de, tde, cur, y);
        NE_FWD_MARK(4 + 3 * q);
        for (int e = tid; e < R * xd; e += kThreads) {
          const int r = e / xd, c = e - r * xd, o = r * H + c;
          const float v = y[o];
          const float xs = kTfx ? x_true(t, 0, r, c) : x_t[o];  // the step's start
          const float xn = stage_next(a.solver, q, xs, dt_of(t, r), v, [&](int i) { return kq[i * RH + o]; });
          if (!last) {
            kq[q * RH + o] = v;
            xde[o] = xn;
          } else {
            x_n[o] = xn;
            xae[o] = kTfx ? x_true(t, 1, r, c) : xn;  // the AE at t+1's input
            if (row0 + r < B) sol_at(t, r)[c] = xn;
          }
        }
        __syncthreads();
        NE_FWD_MARK(14);
        if (last) {
          first_layer<R>(a.ae, tae, xae, s_ae(t), nxt);
        } else {
          first_layer<R>(a.de, tde, xde, s_de(t), nxt);
        }
      }
      cur = nxt;
      NE_FWD_MARK(last ? 15 : 2 + 3 * (q + 1));
    }

    // ---- the AE at t+1: i1; its fold starts step t + 1 ----
    // step t + 1's rows land before the readout's barrier
    cur = fwd_hidden<R, NB>(a.ae, tae, cur, other(cur), wres, wr, true);
    if (a.ae.n == 1) {
      cp_async_wait<0>();
      __syncthreads();
    }
    const bool more = t + 1 < a.tm1;
    const bool ev_n = more && any_ev(t + 1);
    float* nxt = other(cur);
    if constexpr (kFoldPath) {
      if (folder) {
        float yr[kFold];
        fold_readout(a.ae, tae, cur, yr);
        NE_FWD_MARK(15);
#pragma unroll
        for (int c = 0; c < kFold; ++c)
          if (tid == c && c < id) {
            ic[c] = iin[c] = yr[c];
            sol_at(t, 0)[xd + c] = yr[c];
          }
        NE_FWD_MARK(16);
        float in[kFold];  // x_{t+1} was kept by warp 0 in the last stage's fold
#pragma unroll
        for (int c = 0; c < kFold; ++c) in[c] = c < xd ? x_n[c] : pick(yr, c - xd);
        if (more) {
          if (ev_n) {
            fold_first_layer(a.ae, tae, in, s_ev(t + 1), nxt);
          } else {
            fold_first_layer(a.de, tde, in, s_de(t + 1), nxt);
          }
        }
      }
      __syncthreads();
    } else {
      tile_readout<R>(a.ae, tae, cur, y);
      NE_FWD_MARK(15);
      const int w = xd > id ? xd : id;
      for (int e = tid; e < R * w; e += kThreads) {
        const int r = e / w, c = e - r * w, o = r * H + c;
        if (c < xd) {
          if constexpr (kTfx) {  // step t + 1 starts from x_true[t+1]; an event there reads x_{t+1}
            xde[o] = x_true(t + 1, 0, r, c);
            xae[o] = x_n[o];
          } else {
            xde[o] = x_n[o];
          }
        }
        if (c < id) {
          const float v = y[o];
          ic[o] = iin[o] = xde[r * H + xd + c] = v;
          if (row0 + r < B) sol_at(t, r)[xd + c] = v;
        }
      }
      __syncthreads();
      NE_FWD_MARK(16);
      if (more) {
        if (ev_n) {
          first_layer<R>(a.ae, tae, xae, s_ev(t + 1), nxt);
        } else {
          first_layer<R>(a.de, tde, xde, s_de(t + 1), nxt);
        }
      }
    }
    cur = nxt;
    par ^= 1;
  }
}

template <int R, bool kFoldPath, bool kGlobal = false, bool kTfx = false>
cudaError_t launch(Args b, cudaStream_t st) {
  const int X = kTfx ? tf_stride(b.xd) : 0;
  Net* nets[2] = {&b.de, &b.ae};
  // by default, one row a block: the DE's first hidden weight (used S times
  // a step) in registers, its second and the AE's in shared memory; a tile
  // of rows: the DE's in shared memory, the AE's through L1 and L2
  // (phase_clock's [ne-fwd-slots] sweep); buffers in global memory: all
  // through L1 and L2
  const int cap = kGlobal ? 0 : (kSlotCap >= 0 ? kSlotCap : (kFoldPath ? 2 * kMaxTail : b.de.n - 1));
  const int slots = fwd_place(nets, 2, b.H, kFoldPath ? kRegBanks : 0, cap, smem_floats(0, b.de, b.ae, R, b.H, X));
  const size_t smem = kGlobal ? 0 : smem_floats(slots, b.de, b.ae, R, b.H, X) * sizeof(float);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(dae_forward<R, kFoldPath, kGlobal, kTfx>, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (b.batch + R - 1) / R;
  dae_forward<R, kFoldPath, kGlobal, kTfx><<<blocks, kThreads, smem, st>>>(b, slots);
  return cudaGetLastError();
}

// A call's plan: its nets, their padded blocks at the front of the scratch
// (DE then AE, weights then biases; null scratch: the shapes alone), its
// padded width, its rows a block, and the scratch's floats (the padded
// weights, then, where a block's buffers do not fit shared memory, every
// block's buffers).
struct Plan {
  Net de, ae;
  int H;
  FwdShape shape;
  size_t weights, scratch;
};

bool plan(Plan& p, int batch, int h, int xd, int id, int n_de, int n_ae, int rows, float* scratch, bool tf) {
  if (batch < 1 || h < 1 || xd < 1 || id < 1 || n_de < 1 || n_de > kMaxTail || n_ae < 1 || n_ae > kMaxTail ||
      (rows != 1 && rows != 2 && rows != 4 && rows != 8))
    return false;
  p.H = fwd_width(h > xd + id ? h : xd + id);
  const size_t HH = static_cast<size_t>(p.H) * p.H, wd = (n_de + 1) * HH, wa = (n_ae + 1) * HH;
  auto at = [&](size_t off) { return scratch ? scratch + off : nullptr; };
  p.de = make_net(at(0), at(wd + wa), n_de, xd + id, xd, p.H);
  p.ae = make_net(at(wd), at(wd + wa + static_cast<size_t>(n_de) * p.H), n_ae, xd, id, p.H);
  p.weights = wd + wa + static_cast<size_t>(n_de + n_ae) * p.H;
  p.shape = fwd_shape(rows, [&](int R) { return smem_floats(0, p.de, p.ae, R, p.H, tf ? tf_stride(xd) : 0); });
  const size_t blocks = (batch + p.shape.rows - 1) / p.shape.rows;
  p.scratch = p.weights + (p.shape.gmem ? blocks * p.shape.floats : 0);
  return true;
}

// A launch of these sizes: the weights packed, then the rollout (the TF-x
// mode where xt is not null).
int rollout(const void* s_de, const void* s_ae, const void* s_ae_ev, const void* aux, const void* x0, const void* i0,
            const void* wx_de, const void* wi_de, const void* const* de_w, const void* const* de_b, int n_de,
            const void* gx_ae, const void* const* ae_w, const void* const* ae_b, int n_ae, void* scratch, void* sol,
            int tm1, int batch, int h, int xd, int id, int solver, int rows_per_block, const void* xt,
            const void* xt1, void* stream) {
  Plan p;
  float* base = static_cast<float*>(scratch);
  const bool tf = xt != nullptr;
  if (tm1 < 0 || solver < 0 || solver > 2 || !base || (tf && !xt1) ||
      !plan(p, batch, h, xd, id, n_de, n_ae, rows_per_block, base, tf))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tm1 == 0) return static_cast<int>(cudaSuccess);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PackArgs pk{};
  pk.src[0].w0[0] = static_cast<const float*>(wx_de);
  pk.src[0].w0[1] = static_cast<const float*>(wi_de);
  pk.src[0].k0[0] = xd;
  pk.src[0].k0[1] = id;
  pk.src[1].w0[0] = pk.src[1].w0[1] = static_cast<const float*>(gx_ae);
  pk.src[1].k0[0] = xd;
  for (int l = 0; l < n_de; ++l) {
    pk.src[0].w[l] = static_cast<const float*>(de_w[l]);
    pk.src[0].b[l] = static_cast<const float*>(de_b[l]);
  }
  for (int l = 0; l < n_ae; ++l) {
    pk.src[1].w[l] = static_cast<const float*>(ae_w[l]);
    pk.src[1].b[l] = static_cast<const float*>(ae_b[l]);
  }
  pk.dst[0] = p.de;
  pk.dst[1] = p.ae;
  pk.count = 2;
  pk.h = h;
  pk.H = p.H;
  const int pb = pack_blocks(p.weights);
  pack_nets<<<pb, kThreads, 0, st>>>(pk);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a;
  a.s_de = static_cast<const float*>(s_de);
  a.s_ae = static_cast<const float*>(s_ae);
  a.s_ae_ev = static_cast<const float*>(s_ae_ev);
  a.aux = static_cast<const float*>(aux);
  a.x0 = static_cast<const float*>(x0);
  a.i0 = static_cast<const float*>(i0);
  a.de = p.de;
  a.ae = p.ae;
  a.sol = static_cast<float*>(sol);
  a.gmem = p.shape.gmem ? base + p.weights : nullptr;
  a.gmem_block = p.shape.floats;
  a.tm1 = tm1;
  a.batch = batch;
  a.h = h;
  a.H = p.H;
  a.xd = xd;
  a.id = id;
  a.solver = solver;
  a.xt = static_cast<const float*>(xt);
  a.xt1 = static_cast<const float*>(xt1);
  if (tf) {
    if (p.shape.gmem) return static_cast<int>(launch<1, false, true, true>(a, st));
    switch (p.shape.rows) {
      case 1: return static_cast<int>(launch<1, false, false, true>(a, st));
      case 2: return static_cast<int>(launch<2, false, false, true>(a, st));
      case 4: return static_cast<int>(launch<4, false, false, true>(a, st));
      default: return static_cast<int>(launch<8, false, false, true>(a, st));
    }
  }
  const bool fold = narrow_in(a.de) && narrow_out(a.de) && narrow_in(a.ae) && narrow_out(a.ae);
  if (p.shape.gmem) return static_cast<int>(launch<1, false, true>(a, st));
  switch (p.shape.rows) {
    case 1: return static_cast<int>(fold ? launch<1, true>(a, st) : launch<1, false>(a, st));
    case 2: return static_cast<int>(launch<2, false>(a, st));
    case 4: return static_cast<int>(launch<4, false>(a, st));
    default: return static_cast<int>(launch<8, false>(a, st));
  }
}

}  // namespace

// C interface, loaded with ctypes. psn_fused_dae_rollout_scratch: the
// floats of device scratch a launch of these sizes needs (-1: sizes it
// refuses). psn_fused_dae_rollout_f32: pointers are device pointers to
// contiguous float32 arrays in the wrapper's layout (row = input): wx_de
// [xd][h], wi_de [id][h], gx_ae [xd][h]; de_w / de_b, ae_w / ae_b host
// arrays of the tail layers' weights [in][out] and biases [out]; scratch
// of psn_fused_dae_rollout_scratch floats. solver: 0 Euler, 1 Midpoint, 2
// RK4 (3/8 rule). rows_per_block: 1, 2, 4 or 8, the most rows a block takes
// (fewer where their buffers do not fit shared memory). Launches on
// `stream` without synchronising and returns the launches' error (0 on
// success). psn_fused_dae_rollout_tfx_scratch / _tfx_f32: the same in the
// TF-x mode, with the true states xt = x_true[:-1] and xt1 = x_true[1:]
// ([tm1][batch][xd] each).
extern "C" long long psn_fused_dae_rollout_scratch(int batch, int h, int xd, int id, int n_de, int n_ae,
                                                   int rows_per_block) {
  Plan p;
  return plan(p, batch, h, xd, id, n_de, n_ae, rows_per_block, nullptr, false) ? static_cast<long long>(p.scratch)
                                                                                : -1;
}

extern "C" long long psn_fused_dae_rollout_tfx_scratch(int batch, int h, int xd, int id, int n_de, int n_ae,
                                                       int rows_per_block) {
  Plan p;
  return plan(p, batch, h, xd, id, n_de, n_ae, rows_per_block, nullptr, true) ? static_cast<long long>(p.scratch)
                                                                               : -1;
}

extern "C" int psn_fused_dae_rollout_f32(const void* s_de, const void* s_ae, const void* s_ae_ev,
                                         const void* aux, const void* x0, const void* i0, const void* wx_de,
                                         const void* wi_de, const void* const* de_w, const void* const* de_b,
                                         int n_de, const void* gx_ae, const void* const* ae_w,
                                         const void* const* ae_b, int n_ae, void* scratch, void* sol, int tm1,
                                         int batch, int h, int xd, int id, int solver, int rows_per_block,
                                         void* stream) {
  return rollout(s_de, s_ae, s_ae_ev, aux, x0, i0, wx_de, wi_de, de_w, de_b, n_de, gx_ae, ae_w, ae_b, n_ae, scratch,
                 sol, tm1, batch, h, xd, id, solver, rows_per_block, nullptr, nullptr, stream);
}

extern "C" int psn_fused_dae_rollout_tfx_f32(const void* s_de, const void* s_ae, const void* s_ae_ev,
                                             const void* aux, const void* x0, const void* i0, const void* wx_de,
                                             const void* wi_de, const void* const* de_w, const void* const* de_b,
                                             int n_de, const void* gx_ae, const void* const* ae_w,
                                             const void* const* ae_b, int n_ae, void* scratch, void* sol, int tm1,
                                             int batch, int h, int xd, int id, int solver, int rows_per_block,
                                             const void* xt, const void* xt1, void* stream) {
  if (!xt) return static_cast<int>(cudaErrorInvalidValue);
  return rollout(s_de, s_ae, s_ae_ev, aux, x0, i0, wx_de, wi_de, de_w, de_b, n_de, gx_ae, ae_w, ae_b, n_ae, scratch,
                 sol, tm1, batch, h, xd, id, solver, rows_per_block, xt, xt1, stream);
}

extern "C" const char* psn_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
