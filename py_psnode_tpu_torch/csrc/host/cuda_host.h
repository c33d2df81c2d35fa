// A host model of the CUDA subset the port's hand-written kernels use (the
// channel-wise pair and the no-encode forward and backward pairs), so that their
// sources build with g++ and run on a CPU at small shapes
// (py_psnode_tpu_torch/utils/host_build.py). A cluster's blocks run at once,
// the next cluster after them; by default its CUDA threads run as fibers
// (user-level contexts) on the launching OS thread, each switching to the
// next at a barrier it has to wait at; __syncthreads, a warp's collectives
// and the cluster barrier are barriers that a fiber waits at until every
// member has arrived. A barrier that can no longer complete (every fiber
// waits, or has ended) aborts with a message naming the waits, never hangs.
// psn_host_os_threads(1) runs each CUDA thread as an OS thread instead (the
// scheduler of the host model before the fibers, for the test that holds the
// two bit for bit). Shared memory is a poisoned (NaN) buffer per block;
// launches, cudaLaunchKernelEx with a cluster dimension, and the few runtime
// calls the launchers make. Included ahead of the source (g++ -include);
// csrc/host/hopper_ops.cuh models the Hopper instructions.

#pragma once

#include <sys/mman.h>

#include <condition_variable>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <mutex>
#include <optional>
#include <thread>
#include <vector>

#if !defined(__x86_64__)
#include <ucontext.h>
#endif

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};

// One warp's mma operands and sums (hopper_ops.cuh) or shuffled values
// (one each for the warp barrier's even and odd phases), one slot a lane.
struct HostMmaSlot {
  uint32_t a[4], b[2];
  float d[4];
  float f[2];
};
// A cp.async copy, made when its group is waited for.
struct HostCopy {
  float* dst;
  const float* src;
  bool valid;
};

// Whether a launch runs its threads as OS threads (psn_host_os_threads)
// rather than as fibers.
inline bool host_os_threads = false;

struct HostBarrier;
// Parks the calling fiber until b has passed phase (defined below).
void host_fiber_wait(const HostBarrier* b, uint64_t phase);

// A barrier of `count` threads. arrive() returns the phase it arrived in
// (with a function, the last to arrive runs it before the phase completes);
// wait(phase) returns once that phase has completed. Fibers wait by
// switching to another fiber; OS threads on a condition variable.
struct HostBarrier {
  unsigned count, arrived = 0;
  uint64_t phase = 0;
  const char* what;  // for the deadlock report
  unsigned index;
  std::mutex m;
  std::condition_variable cv;
  HostBarrier(unsigned n, const char* w, unsigned i) : count(n), what(w), index(i) {}
  template <class F>
  uint64_t arrive(F last) {
    if (host_os_threads) {
      std::lock_guard<std::mutex> l(m);
      return arrive_locked(last);
    }
    return arrive_locked(last);
  }
  uint64_t arrive() {
    return arrive([] {});
  }
  void wait(uint64_t ph) {
    if (host_os_threads) {
      std::unique_lock<std::mutex> l(m);
      cv.wait(l, [&] { return phase != ph; });
      return;
    }
    if (phase == ph) host_fiber_wait(this, ph);
  }
  void arrive_and_wait() { wait(arrive()); }
  template <class F>
  void arrive_and_wait(F last) { wait(arrive(last)); }

 private:
  template <class F>
  uint64_t arrive_locked(F last) {
    const uint64_t ph = phase;
    if (++arrived == count) {
      last();
      arrived = 0;
      ++phase;
      if (host_os_threads) cv.notify_all();
    }
    return ph;
  }
};

// What a CUDA thread knows.
struct HostThread {
  dim3 tid, bid;  // threadIdx, blockIdx
  HostBarrier* block_bar;
  HostBarrier* warp_bar;
  HostMmaSlot* slots;  // its warp's 32
  float* smem;
  unsigned crank;              // rank in the cluster
  float* const* cluster_smem;  // every block's shared memory, by rank
  HostBarrier* cluster_bar;
  std::optional<uint64_t> token;  // a cluster arrival's phase, until its wait
  std::vector<HostCopy> pending;
  std::vector<size_t> groups;  // ends of the committed copy groups in pending
};
// The running CUDA thread's state: an OS thread's own, or the running
// fiber's, set at each switch (initial-exec: a TLS access without a call).
inline thread_local HostThread* host_cur __attribute__((tls_model("initial-exec"))) = nullptr;
#define threadIdx (host_cur->tid)
#define blockIdx (host_cur->bid)
inline dim3 blockDim, gridDim;  // the launch's: one launch at a time

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__ __attribute__((noinline))
#define __grid_constant__
#define __launch_bounds__(...)
#define __align__(n) alignas(n)

inline void __syncthreads() { host_cur->block_bar->arrive_and_wait(); }
// the value v of lane src of the warp, through the warp's slots (the one of
// the warp barrier's phase parity: a lane overwrites a slot only after every
// lane has read it); every lane of the warp takes part, as in the kernels
inline float host_shfl(float v, int src) {
  const int lane = threadIdx.x & 31;
  const int p = static_cast<int>(host_cur->warp_bar->phase & 1);
  host_cur->slots[lane].f[p] = v;
  host_cur->warp_bar->arrive_and_wait();
  return host_cur->slots[src & 31].f[p];
}
inline float __shfl_xor_sync(unsigned, float v, int m) { return host_shfl(v, (threadIdx.x & 31) ^ m); }
inline float __shfl_sync(unsigned, float v, int src) { return host_shfl(v, src); }
template <class T>
inline T __ldg(const T* p) { return *p; }
template <class T>
inline T __ldcg(const T* p) { return *p; }
inline float __uint_as_float(uint32_t u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline int min(int a, int b) { return a < b ? a : b; }
inline int max(int a, int b) { return a > b ? a : b; }
// the kernels add to an address from one thread only: a plain add models it
inline float atomicAdd(float* p, float v) {
  const float o = *p;
  *p = o + v;
  return o;
}

enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
typedef void* cudaStream_t;
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize,
  cudaFuncAttributeNonPortableClusterSizeAllowed
};
constexpr size_t kHostSmemLimit = 232448;  // an H100 block's dynamic shared memory
inline cudaError_t host_last_error = cudaSuccess;
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute a, int v) {
  if (a != cudaFuncAttributeMaxDynamicSharedMemorySize) return cudaSuccess;
  return static_cast<size_t>(v) <= kHostSmemLimit ? cudaSuccess : cudaErrorInvalidValue;
}
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = host_last_error;
  host_last_error = cudaSuccess;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) { return e ? "invalid value" : "no error"; }

// ---------------------------------------------------------------------------
// Fibers: one stack a CUDA thread (mmap'd, a guard region below it and a
// canary at its lowest word, checked at every switch), switched by hand on
// x86-64 (callee-saved registers, MXCSR and the x87 control word) and by
// swapcontext elsewhere.

constexpr size_t kHostFiberStack = 256 << 10;  // lazily committed
constexpr size_t kHostFiberGuard = 64 << 10;
constexpr uint64_t kHostCanary = 0x5eedc0ffee15deadULL;

#if defined(__x86_64__)
extern "C" void psn_host_fiber_switch(void** save_sp, void* next_sp);
asm(R"(
.text
.p2align 4
.globl psn_host_fiber_switch
.hidden psn_host_fiber_switch
.type psn_host_fiber_switch,@function
psn_host_fiber_switch:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  subq $8, %rsp
  stmxcsr (%rsp)
  fnstcw 4(%rsp)
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  ldmxcsr (%rsp)
  fldcw 4(%rsp)
  addq $8, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
.size psn_host_fiber_switch, .-psn_host_fiber_switch
)");
#endif

struct HostFiber {
  char* map = nullptr;  // guard region, then the stack
#if defined(__x86_64__)
  void* sp = nullptr;
#else
  ucontext_t ctx;
#endif
  HostThread t;
  const HostBarrier* waiting = nullptr;  // parked at this barrier ...
  uint64_t wait_phase = 0;               // ... until it passes this phase
  bool done = false;
  uint64_t* canary() const { return reinterpret_cast<uint64_t*>(map + kHostFiberGuard); }
  bool runnable() const { return !done && (waiting == nullptr || waiting->phase != wait_phase); }
};

struct HostSched {
  std::vector<HostFiber>* fibers = nullptr;
  size_t cur = 0;
  std::function<void()> body;  // the kernel call every fiber makes
#if defined(__x86_64__)
  void* main_sp = nullptr;
#else
  ucontext_t main_ctx;
#endif
};
inline HostSched host_sched;  // the launching thread's: one launch at a time

inline void host_enter(HostFiber& f) { host_cur = &f.t; }

[[noreturn]] inline void host_die(const char* what) {
  std::fprintf(stderr, "host model: %s\n", what);
  std::fflush(stderr);
  std::abort();
}

// Reports the waits of every fiber that has not ended and aborts: no fiber
// can run, so no waiting barrier can complete.
[[noreturn]] inline void host_deadlock() {
  std::vector<HostFiber>& fs = *host_sched.fibers;
  std::fprintf(stderr, "host model: deadlock: no CUDA thread can run; the waits:\n");
  size_t shown = 0, ended = 0;
  for (size_t i = 0; i < fs.size(); ++i) {
    const HostFiber& f = fs[i];
    if (f.done) {
      ++ended;
      continue;
    }
    if (shown++ < 40)
      std::fprintf(stderr, "  block %u thread %u waits at %s %u (%u of %u arrived)\n", f.t.bid.x, f.t.tid.x,
                   f.waiting->what, f.waiting->index, f.waiting->arrived, f.waiting->count);
  }
  std::fprintf(stderr, "  (%zu waiting, %zu ended)\n", shown, ended);
  std::fflush(stderr);
  std::abort();
}

inline void host_switch(HostFiber& from, HostFiber& to) {
  if (*from.canary() != kHostCanary) host_die("a CUDA thread's stack overflowed its fiber stack");
  host_sched.cur = static_cast<size_t>(&to - host_sched.fibers->data());
  host_enter(to);
#if defined(__x86_64__)
  psn_host_fiber_switch(&from.sp, to.sp);
#else
  swapcontext(&from.ctx, &to.ctx);
#endif
}

// The next fiber after the running one, in order, that can run (the running
// one last); nullptr if none.
inline HostFiber* host_next_runnable() {
  std::vector<HostFiber>& fs = *host_sched.fibers;
  const size_t n = fs.size();
  for (size_t k = 1; k <= n; ++k) {
    HostFiber& f = fs[(host_sched.cur + k) % n];
    if (f.runnable()) return &f;
  }
  return nullptr;
}

inline void host_fiber_wait(const HostBarrier* b, uint64_t phase) {
  HostFiber& me = (*host_sched.fibers)[host_sched.cur];
  me.waiting = b;
  me.wait_phase = phase;
  HostFiber* next = host_next_runnable();
  if (next == nullptr) host_deadlock();
  if (next != &me) host_switch(me, *next);
  me.waiting = nullptr;
}

[[noreturn]] inline void host_fiber_main() {
  host_sched.body();
  HostFiber& me = (*host_sched.fibers)[host_sched.cur];
  if (me.t.token) host_die("a cluster arrival without its wait");
  me.done = true;
  HostFiber* next = host_next_runnable();
  if (next == nullptr) {
    for (const HostFiber& f : *host_sched.fibers)
      if (!f.done) host_deadlock();  // waits that no fiber is left to complete
    if (*me.canary() != kHostCanary) host_die("a CUDA thread's stack overflowed its fiber stack");
#if defined(__x86_64__)
    psn_host_fiber_switch(&me.sp, host_sched.main_sp);
#else
    swapcontext(&me.ctx, &host_sched.main_ctx);
#endif
  } else {
    host_switch(me, *next);
  }
  host_die("an ended fiber was resumed");
}

// The fibers' stacks, kept for later launches.
inline std::vector<char*> host_stacks;

inline char* host_stack(size_t i) {
  while (host_stacks.size() <= i) {
    void* p = mmap(nullptr, kHostFiberGuard + kHostFiberStack, PROT_READ | PROT_WRITE,
                   MAP_PRIVATE | MAP_ANONYMOUS | MAP_NORESERVE, -1, 0);
    if (p == MAP_FAILED) host_die("mmap of a fiber stack failed");
    if (mprotect(p, kHostFiberGuard, PROT_NONE) != 0) host_die("mprotect of a fiber stack's guard failed");
    host_stacks.push_back(static_cast<char*>(p));
  }
  return host_stacks[i];
}

// Runs fs (their t set) as fibers until all have ended.
inline void host_run_fibers(std::vector<HostFiber>& fs, std::function<void()> body) {
  host_sched.fibers = &fs;
  host_sched.body = std::move(body);
  for (size_t i = 0; i < fs.size(); ++i) {
    HostFiber& f = fs[i];
    f.map = host_stack(i);
    *f.canary() = kHostCanary;
    char* top = f.map + kHostFiberGuard + kHostFiberStack;
#if defined(__x86_64__)
    // the frame psn_host_fiber_switch pops: MXCSR and control word, six
    // registers, then host_fiber_main as the return address, entered with
    // the stack aligned as after a call
    uint64_t* sp = reinterpret_cast<uint64_t*>(top) - 1;
    *--sp = reinterpret_cast<uint64_t>(&host_fiber_main);  // at a 16-byte boundary
    for (int r = 0; r < 6; ++r) *--sp = 0;
    --sp;  // the launching thread's floating-point modes
    asm volatile("stmxcsr (%0)\n\tfnstcw 4(%0)" : : "r"(sp) : "memory");
    f.sp = sp;
#else
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.map + kHostFiberGuard;
    f.ctx.uc_stack.ss_size = kHostFiberStack;
    f.ctx.uc_link = nullptr;
    makecontext(&f.ctx, reinterpret_cast<void (*)()>(&host_fiber_main), 0);
#endif
  }
  host_sched.cur = 0;
  HostThread* const saved = host_cur;
  host_enter(fs[0]);
#if defined(__x86_64__)
  psn_host_fiber_switch(&host_sched.main_sp, fs[0].sp);
#else
  swapcontext(&host_sched.main_ctx, &fs[0].ctx);
#endif
  host_cur = saved;
  host_sched.fibers = nullptr;
  host_sched.body = nullptr;
}

// Runs the grid one cluster of kc blocks (along x) at a time, the cluster's
// blocks at once, as fibers or (os_threads) as OS threads.
template <class K, class... A>
void host_launch(K kernel, dim3 grid, dim3 block, size_t smem, unsigned kc, bool os_threads,
                 const A&... args) {
  const unsigned nt = block.x * block.y * block.z;
  if (nt > 1024 || nt % 32 || smem > kHostSmemLimit || grid.x % kc) {
    host_last_error = cudaErrorInvalidValue;
    return;
  }
  const unsigned nw = nt / 32;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned cx = 0; cx < grid.x; cx += kc) {
        std::vector<std::vector<float>> store(kc, std::vector<float>(smem / 4 + 4, std::nanf("")));
        std::vector<float*> base(kc);
        for (unsigned r = 0; r < kc; ++r)  // 16-byte aligned, as the card's
          base[r] = reinterpret_cast<float*>(
              (reinterpret_cast<uintptr_t>(store[r].data()) + 15) & ~uintptr_t(15));
        HostBarrier cluster_bar(nt * kc, "the cluster barrier", 0);
        std::vector<std::unique_ptr<HostBarrier>> block_bars, warp_bars;
        for (unsigned r = 0; r < kc; ++r)
          block_bars.emplace_back(new HostBarrier(nt, "__syncthreads of block", cx + r));
        for (unsigned w = 0; w < nw * kc; ++w) warp_bars.emplace_back(new HostBarrier(32, "the barrier of warp", w));
        std::vector<HostMmaSlot> slots(nt * kc);
        auto state = [&](unsigned r, unsigned t, HostThread& s) {
          s.tid = dim3(t % block.x, (t / block.x) % block.y, t / (block.x * block.y));
          s.bid = dim3(cx + r, by, bz);
          s.block_bar = block_bars[r].get();
          s.warp_bar = warp_bars[r * nw + t / 32].get();
          s.slots = slots.data() + r * nt + (t / 32) * 32;
          s.smem = base[r];
          s.crank = r;
          s.cluster_smem = base.data();
          s.cluster_bar = &cluster_bar;
        };
        blockDim = block;
        gridDim = grid;
        if (!os_threads) {
          std::vector<HostFiber> fs(nt * kc);
          for (unsigned r = 0; r < kc; ++r)
            for (unsigned t = 0; t < nt; ++t) {
              state(r, t, fs[r * nt + t].t);
            }
          host_run_fibers(fs, [&] { kernel(args...); });
          continue;
        }
        std::vector<std::thread> threads;
        threads.reserve(nt * kc);
        for (unsigned r = 0; r < kc; ++r)
          for (unsigned t = 0; t < nt; ++t)
            threads.emplace_back([&, r, t] {
              HostThread s;
              state(r, t, s);
              host_cur = &s;
              kernel(args...);
              if (s.token) host_die("a cluster arrival without its wait");
            });
        for (auto& th : threads) th.join();
      }
}

// kernel<<<grid, block, smem, stream>>>(args...), as host_build.py rewrites it
template <class K, class... A>
void host_launch_plain(K kernel, dim3 grid, dim3 block, size_t smem, cudaStream_t,
                       const A&... args) {
  host_launch(kernel, grid, block, smem, 1, host_os_threads, args...);
}

enum cudaLaunchAttributeID { cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct {
    struct {
      unsigned x, y, z;
    } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline unsigned host_cluster_of(const cudaLaunchConfig_t* c) {
  for (unsigned i = 0; i < c->numAttrs; ++i)
    if (c->attrs[i].id == cudaLaunchAttributeClusterDimension) return c->attrs[i].val.clusterDim.x;
  return 1;
}
template <class K, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* c, K kernel, const A&... args) {
  host_launch(kernel, c->gridDim, c->blockDim, c->dynamicSmemBytes, host_cluster_of(c), host_os_threads,
              args...);
  return cudaGetLastError();
}
// a model card of 132 SMs that holds one block an SM
template <class K>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, K, const cudaLaunchConfig_t* c) {
  *n = 132 / static_cast<int>(host_cluster_of(c));
  return cudaSuccess;
}

// Selects the scheduler of later launches: OS threads when on is nonzero,
// else fibers (the default); returns the previous choice.
extern "C" int psn_host_os_threads(int on) {
  const int was = host_os_threads;
  host_os_threads = on != 0;
  return was;
}
