// The fast-stack probe: STEPS x NL layers of int8 weight-only matvecs in
// one persistent cooperative kernel.
//
// Replaces the Pallas TPU probe fish_speech_tpu/ops/pallas_faststack.py
// (make_probe, kernel :144, call :312). Per layer, on x (DF) fp32:
//   u = x @ Wqkv                       (DF -> DQKV)
//   y = u[:DF] * (1 + 1e-3 * sum(u[DF:]))   (mock attention)
//   x = x + y @ Wo                     (DF -> DF)
//   f = rms(x) @ W13                   (DF -> 2*INTER)
//   x = rms(x + (silu(f[:INTER]) * f[INTER:]) @ W2)   (INTER -> DF)
// with int8 weights and fp32 per-column scales. Each layer reads its own
// weights: the TPU kernel's prefetch of piece t+2 into the slot being read
// (consume, :180-189) is a race this kernel does not copy.
//
// Variants: "bf16" rounds the activation to bf16 and multiplies the int8
// weight (exact in fp32) with fp32 accumulation, as _dot_bf16 does; "w8a8"
// quantizes the activation per matvec to int8 with its absmax (quant_x,
// :191-196) and sums int8 x int8 products in int32 with __dp4a, then
// scales by x_scale * column scale, as _dot_w8a8 does.
//
// What bounds it on the H100: every matvec does 2 operations per weight
// byte, so a frame moves STEPS * NL * 34.6 MB of int8 weight at flagship
// dims (4.15 GB) for ~8.3 GFLOP: bytes, 1.24 ms at 3.35 TB/s.
//
// Design: one cooperative launch runs the whole frame, one block per SM.
// The weights do not depend on the activations, so they need not wait for
// the barriers between the stages that do: a producer warp streams each
// block's weights into a ring of 16 KB slots in shared memory with 1-D
// bulk copies (cp.async.bulk against the slots' mbarriers), running ahead
// of the eight consumer warps across their grid barriers, so the memory
// keeps streaming while the consumers wait (8, 32 and 64 KB slots measured
// slower). The consumers' barriers leave the producer out: named barrier 1
// inside the block, and a grid barrier of their own (one release add per
// block on a word whose top bit flips at each barrier, the scheme of
// cooperative groups' grid sync).
//
// Work split: the columns of each matrix are cut into units of 4; block b
// owns units [b NU / NB, (b + 1) NU / NB) of every matrix, over all rows, so
// no sum crosses blocks: each column's sum is stored by its block (no
// atomics, no zeroing, the same bits on every run). The weights are packed
// once per weight set (`ops/faststack.py:pack_weights`, outside the frame):
// layer by layer (the first R layers are one range, for the L2 window),
// then block by block, then matrix by matrix; a block's strip of a matrix
// is its quads of 4 rows, each quad's units, each unit a 4 x 4 tile stored
// column by column (column c's 4 rows at bytes 4c..4c+3), so one dp4a
// takes a column of a quad; W13's units pair gate and up columns. A
// stage's strip streams in chunks of whole quads. Consumer thread t of an
// n-unit strip takes unit t % n and every P-th quad (P = 256 / n); one
// thread then adds a column's P partial sums in a fixed order and the
// block stores the stage's output for its columns: u = x Wqkv, x_mid =
// x_in + y Wo, g = silu(gate) * up, h = x_mid + g W2.
//
// The small vector work between matvecs (rms, the mock-attention sum and
// mix, the activation's bf16 rounding or int8 quantization) is done by
// every block from those global vectors after the barrier, in the same
// order in every block, so all blocks agree bit for bit. "Resident" layers
// cannot live in shared memory (132 x 227 KB < one 34.6 MB layer): the
// first R layers are read through an L2 persisting access-policy window
// (50 MB of L2) and with an evict-last hint, the streamed ones with
// evict-first; R changes where the bytes come from, never the math.
//
// `part` runs a piece of the frame alone, to time it: the grid barriers
// alone (kBarriers), or the weight stream alone (kLoads: the producer as
// in a frame, the consumers only releasing each slot).

#include "common.cuh"
#include "tma.cuh"

namespace {

constexpr int NC = 256;          // consumer threads (8 warps)
constexpr int NCW = NC / 32;
constexpr int NT = NC + 32;      // and the producer warp
constexpr int SLOT = 16384;      // bytes of a ring slot
constexpr int MAX_SLOTS = 16;
constexpr float kRmsEps = 1e-5f;

enum Part { kFrame = 0, kBarriers = 1, kLoads = 2 };

struct Probe {
  const int8_t* w;    // packed (NL, layer_bytes), see above
  const float* sc;    // (NL, DQKV + DF + 2 INTER + DF) column scales, in
                      // the order Wqkv | Wo | W13 | W2
  const float* x0;    // (DF) input
  float* out;         // (DF) output
  float* ws;          // workspace, see the offsets below
  unsigned* bar;      // the grid barrier's word
  int df, dqkv, inter, n_layer, steps, r_resident, n_slots, part;
};

// A wait that outlasts this ends the launch with an error (a trap) instead
// of hanging the card: a frame takes milliseconds.
constexpr uint64_t kStuckNs = 10000000000ull;

__device__ __forceinline__ uint64_t now_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits for an mbarrier's phase `parity` (or traps, see kStuckNs)
__device__ __forceinline__ void slot_wait(uint64_t* bar, uint32_t parity) {
  if (fs::tma::bar_try_wait(bar, parity)) return;
  const uint64_t t0 = now_ns();
  for (unsigned n = 1; !fs::tma::bar_try_wait(bar, parity); ++n)
    if (n % 256 == 0 && now_ns() - t0 > kStuckNs) __trap();
}

// the consumer threads of the block (the producer warp never joins)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" :: "n"(NC) : "memory");
}

// Every block's consumers: all stores before it are seen by all loads after
// it. The top bit of *bar flips once all blocks have arrived; thread 0
// arrives with a release add and waits with acquire loads, around block
// syncs (CUTLASS's generic barrier does the same; a __threadfence on each
// side instead, as cooperative groups' grid sync has, was slower).
__device__ void grid_sync(unsigned* bar) {
  consumer_sync();
  if (threadIdx.x == 0) {
    const unsigned inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    unsigned old;  // the release publishes the block's stores (after the sync)
    asm volatile("atom.release.gpu.global.add.u32 %0, [%1], %2;\n"
                 : "=r"(old) : "l"(bar), "r"(inc) : "memory");
    const uint64_t t0 = now_ns();
    unsigned now;
    for (unsigned n = 1;; ++n) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(now) : "l"(bar) : "memory");
      if ((old ^ now) & 0x80000000u) break;
      if (n % 256 == 0 && now_ns() - t0 > kStuckNs) __trap();
    }
  }
  consumer_sync();  // the acquire orders the block's loads after the flip
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ float block_reduce(float v, float* red, bool is_max) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = is_max ? fs::warp_max(v) : fs::warp_sum(v);
  consumer_sync();  // red may still be read from the previous reduction
  if (lane == 0) red[warp] = v;
  consumer_sync();
  float r = red[0];
  for (int i = 1; i < NCW; ++i) r = is_max ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// Activation prepared in shared memory for one matvec: bf16-rounded
// floats (act_f) or int8 with its scale (act_q, returned).
template <bool W8A8>
__device__ float prepare_act(float* act_f, int8_t* act_q, int n, float* red) {
  if (!W8A8) {
    for (int i = threadIdx.x; i < n; i += NC) act_f[i] = bf16_round(act_f[i]);
    consumer_sync();
    return 1.f;
  }
  float m = 0.f;
  for (int i = threadIdx.x; i < n; i += NC) m = fmaxf(m, fabsf(act_f[i]));
  const float xs = block_reduce(m, red, true) / 127.f;
  const float inv = fmaxf(xs, 1e-12f);
  for (int i = threadIdx.x; i < n; i += NC)
    act_q[i] = (int8_t)fminf(fmaxf(rintf(act_f[i] / inv), -127.f), 127.f);
  consumer_sync();
  return xs;
}

// This block's strip of matrix m (0 Wqkv, 1 Wo, 2 W13, 3 W2) of a layer:
// its first unit, its units, the matrix's rows and the strip's byte offset
// in the packed layer (`ops/faststack.py:piece_plan`).
struct Strip {
  int u0, nu, in;
  size_t off;
};

__device__ Strip strip(const Probe& a, int m) {
  const int ins[4] = {a.df, a.df, a.df, a.inter};
  const int outs[4] = {a.dqkv, a.df, 2 * a.inter, a.df};
  const int b = blockIdx.x, nb = gridDim.x;
  Strip s{0, 0, ins[m], 0};
  for (int k = 0; k < 4; ++k) {
    const int units = outs[k] / 4;
    const int u0 = b * units / nb, u1 = (b + 1) * units / nb;
    s.off += (size_t)ins[k] * 4 * u0;            // the blocks before b
    if (k < m) s.off += (size_t)ins[k] * 4 * (u1 - u0);  // b's earlier strips
    if (k == m) s.u0 = u0, s.nu = u1 - u0;
  }
  return s;
}

// quads of a strip's chunk: whole quads of all its units in one slot
__device__ __forceinline__ int chunk_quads(int nu) { return SLOT / (16 * nu); }

// A place in the ring: the slot of the next chunk and the parity of its
// barriers' phase (flipped at each pass over the ring).
struct RingPos {
  int slot = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int n_slots) {
    if (++slot == n_slots) slot = 0, phase ^= 1;
  }
};

// The producer (lane 0 of the last warp): every chunk of the frame, in the
// consumers' order, each into the next slot once its consumers left it.
__device__ void produce(const Probe& a, unsigned char* ring, uint64_t* full,
                        uint64_t* empty) {
  if ((threadIdx.x & 31) != 0) return;
  uint64_t evict_first, evict_last;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(evict_first));
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;\n"
               : "=l"(evict_last));
  Strip st[4];
  for (int m = 0; m < 4; ++m) st[m] = strip(a, m);
  const size_t layer_bytes = (size_t)a.df * a.dqkv + (size_t)a.df * a.df +
                             (size_t)a.df * 2 * a.inter + (size_t)a.inter * a.df;
  RingPos at;
  for (int it = 0; it < a.steps * a.n_layer; ++it) {
    const int l = it % a.n_layer;
    const int8_t* wl = a.w + (size_t)l * layer_bytes;
    const uint64_t policy = l < a.r_resident ? evict_last : evict_first;
    for (int m = 0; m < 4; ++m) {
      const Strip& s = st[m];
      if (s.nu == 0) continue;
      const int quads = s.in / 4, cq = chunk_quads(s.nu);
      for (int q0 = 0; q0 < quads; q0 += cq, at.next(a.n_slots)) {
        // the slot's previous chunk was released (a fresh barrier passes)
        slot_wait(&empty[at.slot], at.phase ^ 1);
        const uint32_t bytes = (uint32_t)(min(cq, quads - q0) * 16 * s.nu);
        fs::tma::bar_expect(&full[at.slot], bytes);
        fs::tma::load_1d(ring + (size_t)at.slot * SLOT,
                         wl + s.off + (size_t)q0 * 16 * s.nu, bytes,
                         &full[at.slot], policy);
      }
    }
  }
}

// a + b of two column sums (int32 bits under w8a8)
template <bool W8A8>
__device__ __forceinline__ float add(float a, float b) {
  if (W8A8) return __int_as_float(__float_as_int(a) + __float_as_int(b));
  return a + b;
}

// The column-scaled value of a column sum (int32 bits under w8a8).
template <bool W8A8>
__device__ __forceinline__ float scaled(float sum, float s, float xs) {
  if (W8A8) return (float)__float_as_int(sum) * (xs * s);
  return sum * s;
}

// The global vectors between the stages (fp32, written by the blocks that
// own their columns, read by every block after the barrier).
struct Vecs {
  float *x_in, *x_mid, *u, *g, *h;
};

// act[I] @ W[I, strip] for this block's strip s of matrix m, chunk by
// chunk from the ring (k counts the frame's chunks), then the stage's
// output for the strip's columns: m = 0 u = Wqkv's columns; 1 x_mid = x_in
// + Wo's; 2 g = silu(gate) * up (W13's units are packed as gate 2u, 2u + 1,
// up 2u, 2u + 1); 3 h = x_mid + W2's. red_cols holds NC x 4 partial sums.
template <bool W8A8>
__device__ void matvec(const Probe& a, int m, const Strip& s, const float* sc,
                       float xs, const float* act_f, const int8_t* act_q,
                       const Vecs& v, const unsigned char* ring, uint64_t* full,
                       uint64_t* empty, float* red_cols, RingPos& at) {
  if (s.nu == 0) return;
  const int t = threadIdx.x, lane = t & 31;
  const int P = NC / s.nu;          // threads per unit
  const bool active = t < P * s.nu;
  const int u = t % s.nu, p = t / s.nu;
  const int quads = s.in / 4, cq = chunk_quads(s.nu);
  // the epilogue's residual entries, fetched while the chunks stream
  // the epilogue's column scales and residual entries (thread t takes
  // columns t + n NC, or the gate/up pairs t + n NC under W13), fetched
  // while the chunks stream
  constexpr int RN = 4;  // columns per thread at most: 4 nu <= 4 NC
  float resid[RN], sc0[RN], sc1[RN];
#pragma unroll
  for (int n = 0; n < RN; ++n) {
    const int j = t + n * NC;
    if (m == 2) {
      const int i = 2 * s.u0 + j;  // gate column i, up column INTER + i
      if (j < 2 * s.nu) sc0[n] = sc[i], sc1[n] = sc[a.inter + i];
    } else if (j < 4 * s.nu) {
      sc0[n] = sc[4 * s.u0 + j];
      if (m != 0) resid[n] = __ldcg((m == 1 ? v.x_in : v.x_mid) + 4 * s.u0 + j);
    }
  }
  float facc[4] = {0.f, 0.f, 0.f, 0.f};
  int iacc[4] = {0, 0, 0, 0};
  // one 16-byte tile (quad q, this thread's unit) into the sums
  auto tile = [&](const uint4& w, int q) {
    const uint32_t col[4] = {w.x, w.y, w.z, w.w};
    if (W8A8) {
      const int xp = *reinterpret_cast<const int*>(act_q + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) iacc[c] = __dp4a((int)col[c], xp, iacc[c]);
    } else {
      const float4 x = *reinterpret_cast<const float4*>(act_f + 4 * q);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t wx = col[c] ^ 0x80808080u;
        facc[c] = fmaf(x.x, fs::i8_to_f32<0>(wx), facc[c]);
        facc[c] = fmaf(x.y, fs::i8_to_f32<1>(wx), facc[c]);
        facc[c] = fmaf(x.z, fs::i8_to_f32<2>(wx), facc[c]);
        facc[c] = fmaf(x.w, fs::i8_to_f32<3>(wx), facc[c]);
      }
    }
  };
  const int step = P * s.nu;  // uint4s between this thread's quads
  int r = p;                  // (p - q0) mod P: its first quad is q0 + r
  for (int q0 = 0; q0 < quads; q0 += cq, at.next(a.n_slots)) {
    slot_wait(&full[at.slot], at.phase);
    const int q1 = min(q0 + cq, quads);
    if (active) {
      // its quads q = p (mod P) of the chunk, in order, four loads at a time
      const uint4* w = reinterpret_cast<const uint4*>(ring + (size_t)at.slot * SLOT) +
                       r * s.nu + u;
      for (int q = q0 + r; q < q1; q += 4 * P, w += 4 * step) {
        uint4 x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + i * P < q1) x[i] = w[i * step];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (q + i * P < q1) tile(x[i], q + i * P);
      }
    }
    r -= cq % P;
    if (r < 0) r += P;
    __syncwarp();
    if (lane == 0) fs::tma::bar_arrive(&empty[at.slot]);  // the warp left the slot
  }
  if (active)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red_cols[t * 4 + c] = W8A8 ? __int_as_float(iacc[c]) : facc[c];
  consumer_sync();
  // column j = 4 uj + c: its P partial sums (partial i at 4 (i nu + uj) + c),
  // in four chains i = 0, 1, 2, 3 (mod 4), (s0 + s1) + (s2 + s3); the sum
  // goes where partial 0 was, which only this thread reads
  const int stride = 4 * s.nu;
  for (int j = t; j < stride; j += NC) {
    float c0 = 0.f, c1 = 0.f, c2 = 0.f, c3 = 0.f;  // int32 bits under w8a8
    for (int i = 0; i < P; i += 4) {
      const float* r = red_cols + i * stride + j;
      c0 = add<W8A8>(c0, r[0]);
      if (i + 1 < P) c1 = add<W8A8>(c1, r[stride]);
      if (i + 2 < P) c2 = add<W8A8>(c2, r[2 * stride]);
      if (i + 3 < P) c3 = add<W8A8>(c3, r[3 * stride]);
    }
    red_cols[j] = add<W8A8>(add<W8A8>(c0, c1), add<W8A8>(c2, c3));
  }
  consumer_sync();
#pragma unroll
  for (int n = 0; n < RN; ++n) {
    const int j = t + n * NC;
    if (m == 2) {  // gate and up of the pair i = 2 (u0 + uj) + e
      if (j >= 2 * s.nu) break;
      const int uj = j / 2, e = j % 2;
      const float f1 = scaled<W8A8>(red_cols[4 * uj + e], sc0[n], xs);
      const float f3 = scaled<W8A8>(red_cols[4 * uj + 2 + e], sc1[n], xs);
      v.g[2 * s.u0 + j] = f1 / (1.f + expf(-f1)) * f3;
      continue;
    }
    if (j >= 4 * s.nu) break;
    const int o = 4 * s.u0 + j;
    const float y = scaled<W8A8>(red_cols[j], sc0[n], xs);
    if (m == 0) v.u[o] = y;
    else if (m == 1) v.x_mid[o] = resid[n] + y;
    else v.h[o] = resid[n] + y;
  }
}

// The consumers release every chunk of the frame unread (part kLoads).
__device__ void drain(const Probe& a, const Strip* st, uint64_t* full,
                      uint64_t* empty) {
  RingPos at;
  for (int it = 0; it < a.steps * a.n_layer; ++it)
    for (int m = 0; m < 4; ++m) {
      const Strip& s = st[m];
      if (s.nu == 0) continue;
      for (int q0 = 0; q0 < s.in / 4; q0 += chunk_quads(s.nu), at.next(a.n_slots)) {
        slot_wait(&full[at.slot], at.phase);
        __syncwarp();
        if ((threadIdx.x & 31) == 0) fs::tma::bar_arrive(&empty[at.slot]);
      }
    }
}

// n values of a global vector into act (read past L1: other blocks stored
// them); returns this thread's sum of their squares
__device__ float load_vec(float* act, const float* src, int n) {
  float ss = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < n / 4; i += NC) {
    const float4 x = __ldcg(reinterpret_cast<const float4*>(src) + i);
    reinterpret_cast<float4*>(act)[i] = x;
    ss += x.x * x.x + x.y * x.y + x.z * x.z + x.w * x.w;
  }
  return ss;
}

// act *= rsqrt(mean(act^2) + eps) over n values, from this thread's ss
__device__ void rms_norm(float* act, float ss, int n, float* red) {
  const float r = rsqrtf(block_reduce(ss, red, false) / n + kRmsEps);
  for (int i = threadIdx.x; i < n; i += NC) act[i] *= r;
}

template <bool W8A8>
__global__ void __launch_bounds__(NT, 1) faststack_kernel(Probe a) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full[MAX_SLOTS], empty[MAX_SLOTS];
  const int DF = a.df, DQKV = a.dqkv, INTER = a.inter;
  const int amax = max(DF, INTER);
  unsigned char* ring = smem;                                   // [n_slots][SLOT]
  float* act_f = reinterpret_cast<float*>(ring + (size_t)a.n_slots * SLOT);  // [amax]
  float* red_cols = act_f + amax;                               // [NC * 4]
  float* red = red_cols + NC * 4;                               // [32]
  int8_t* act_q = reinterpret_cast<int8_t*>(red + 32);          // [amax]

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.n_slots; ++i) {
      fs::tma::bar_init(&full[i], 1);
      fs::tma::bar_init(&empty[i], NCW);
    }
    fs::tma::bar_init_fence();
  }
  __syncthreads();  // the barriers' init is visible; the last sync of all
  if (threadIdx.x >= NC) {
    if (a.part != kBarriers) produce(a, ring, full, empty);
    return;
  }
  const int total = a.steps * a.n_layer;
  if (a.part == kBarriers) {
    for (int i = 0; i < 4 * total; ++i) grid_sync(a.bar);
    return;
  }
  Strip st[4];
  for (int m = 0; m < 4; ++m) st[m] = strip(a, m);
  if (a.part == kLoads) {
    drain(a, st, full, empty);
    return;
  }

  Vecs v;
  v.x_in = a.ws;           // the layer's input (rms output), block 0 stores it
  v.x_mid = v.x_in + DF;   // after the attention residual
  v.u = v.x_mid + DF;      // x @ Wqkv
  v.g = v.u + DQKV;        // silu(gate) * up
  v.h = v.g + INTER;       // x_mid + g @ W2, the next layer's rms input
  const int sc_len = DQKV + DF + 2 * INTER + DF;
  RingPos at;  // the next chunk's place in the ring

  for (int it = 0; it < total; ++it) {
    const float* s_qkv = a.sc + (size_t)(it % a.n_layer) * sc_len;
    const float* s_wo = s_qkv + DQKV;
    const float* s_w13 = s_wo + DF;
    const float* s_w2 = s_w13 + 2 * INTER;

    // A: the layer input (rms of the previous layer's h), then x @ Wqkv
    if (it == 0) {
      for (int i = threadIdx.x; i < DF; i += NC) act_f[i] = a.x0[i];
    } else {
      rms_norm(act_f, load_vec(act_f, v.h, DF), DF, red);
    }
    consumer_sync();
    if (blockIdx.x == 0)
      for (int i = threadIdx.x; i < DF; i += NC) v.x_in[i] = act_f[i];
    float xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(a, 0, st[0], s_qkv, xs, act_f, act_q, v, ring, full, empty,
                 red_cols, at);
    grid_sync(a.bar);

    // B: mock attention, then y @ Wo
    float kv = 0.f;
    for (int i = DF / 4 + threadIdx.x; i < DQKV / 4; i += NC) {
      const float4 x = __ldcg(reinterpret_cast<const float4*>(v.u) + i);
      kv += (x.x + x.y) + (x.z + x.w);
    }
    const float mix = 1.f + block_reduce(kv, red, false) * 1e-3f;
    for (int i = threadIdx.x; i < DF / 4; i += NC) {
      float4 x = __ldcg(reinterpret_cast<const float4*>(v.u) + i);
      x.x *= mix, x.y *= mix, x.z *= mix, x.w *= mix;
      reinterpret_cast<float4*>(act_f)[i] = x;
    }
    consumer_sync();
    xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(a, 1, st[1], s_wo, xs, act_f, act_q, v, ring, full, empty,
                 red_cols, at);
    grid_sync(a.bar);

    // C: rms of the attention residual, then h @ W13 and silu(gate) * up
    rms_norm(act_f, load_vec(act_f, v.x_mid, DF), DF, red);
    consumer_sync();
    xs = prepare_act<W8A8>(act_f, act_q, DF, red);
    matvec<W8A8>(a, 2, st[2], s_w13, xs, act_f, act_q, v, ring, full, empty,
                 red_cols, at);
    grid_sync(a.bar);

    // D: g @ W2 and the residual
    load_vec(act_f, v.g, INTER);
    consumer_sync();
    xs = prepare_act<W8A8>(act_f, act_q, INTER, red);
    matvec<W8A8>(a, 3, st[3], s_w2, xs, act_f, act_q, v, ring, full, empty,
                 red_cols, at);
    grid_sync(a.bar);
  }

  // the last layer's rms output
  rms_norm(act_f, load_vec(act_f, v.h, DF), DF, red);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < DF; i += NC) a.out[i] = act_f[i];
}

size_t smem_bytes(int df, int inter, int n_slots) {
  const int amax = df > inter ? df : inter;
  return (size_t)n_slots * SLOT + sizeof(float) * ((size_t)amax + NC * 4 + 32) + amax;
}

// Launches the frame on n_blocks blocks (the count the weights were packed
// for), one per SM, with as many ring slots as the shared memory holds.
template <bool W8A8>
cudaError_t launch(Probe a, int n_blocks, cudaStream_t s) {
  int dev = 0, n_sm = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes fa;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, faststack_kernel<W8A8>);
  if (e != cudaSuccess) return e;
  if (n_blocks > n_sm) return cudaErrorInvalidConfiguration;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  a.n_slots = MAX_SLOTS;
  while (a.n_slots > 2 && smem_bytes(a.df, a.inter, a.n_slots) > room) --a.n_slots;
  const size_t smem = smem_bytes(a.df, a.inter, a.n_slots);
  if (smem > room) return cudaErrorInvalidConfiguration;
  e = cudaFuncSetAttribute(faststack_kernel<W8A8>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, faststack_kernel<W8A8>,
                                                      NT, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  void* args[] = {&a};
  return cudaLaunchCooperativeKernel((void*)faststack_kernel<W8A8>, n_blocks, NT,
                                     args, smem, s);
}

}  // namespace

// One frame: w (NL, layer_bytes) int8 packed for n_blocks blocks
// (`ops/faststack.py:pack_weights`), sc (NL, DQKV + DF + 2 INTER + DF) fp32,
// x0/out (DF) fp32, ws (3 DF + DQKV + INTER) fp32, bar one uint32 that is
// 0 before the first launch (each launch leaves it 0 or 0x80000000). With
// r_resident > 0 the first r_resident layers are read through an L2
// persisting access-policy window set on `stream` for this launch. part: 0
// the frame, 1 its grid barriers alone, 2 its weight stream alone.
extern "C" int fs_faststack_probe(const void* w, const void* sc, const void* x0,
                                  void* out, void* ws, void* bar, int df,
                                  int dqkv, int inter, int n_layer, int steps,
                                  int r_resident, int w8a8, int n_blocks,
                                  int part, void* stream) {
  if (df % 16 || dqkv % 16 || inter % 16 || dqkv <= df || n_layer < 1 ||
      steps < 1 || r_resident < 0 || r_resident >= n_layer || n_blocks < 1 ||
      part < kFrame || part > kLoads)
    return (int)cudaErrorInvalidValue;
  // a strip's units: at most one per consumer thread
  const int most_units = (2 * inter / 4 + n_blocks - 1) / n_blocks;
  if (most_units > NC || (dqkv / 4 + n_blocks - 1) / n_blocks > NC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Probe a{static_cast<const int8_t*>(w), static_cast<const float*>(sc),
          static_cast<const float*>(x0), static_cast<float*>(out),
          static_cast<float*>(ws), static_cast<unsigned*>(bar), df, dqkv, inter,
          n_layer, steps, r_resident, 0, part};
  cudaError_t e;
  if (r_resident > 0) {
    int dev = 0, max_persist = 0, max_window = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_persist, cudaDevAttrMaxPersistingL2CacheSize, dev);
    cudaDeviceGetAttribute(&max_window, cudaDevAttrMaxAccessPolicyWindowSize, dev);
    const size_t layer_bytes = (size_t)df * dqkv + (size_t)df * df +
                               (size_t)df * 2 * inter + (size_t)inter * df;
    size_t window = layer_bytes * r_resident;
    if (window > (size_t)max_window) window = (size_t)max_window;
    const size_t persist = window < (size_t)max_persist ? window : (size_t)max_persist;
    e = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, persist);
    if (e != cudaSuccess) return (int)e;
    cudaStreamAttrValue attr = {};
    attr.accessPolicyWindow.base_ptr = const_cast<void*>(w);
    attr.accessPolicyWindow.num_bytes = window;
    attr.accessPolicyWindow.hitRatio = window ? (float)persist / (float)window : 0.f;
    attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;
    attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;
    e = cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    if (e != cudaSuccess) return (int)e;
  }
  e = w8a8 ? launch<true>(a, n_blocks, s) : launch<false>(a, n_blocks, s);
  if (r_resident > 0) {
    cudaStreamAttrValue attr = {};  // num_bytes 0: no window for later work
    const cudaError_t e2 =
        cudaStreamSetAttribute(s, cudaStreamAttributeAccessPolicyWindow, &attr);
    if (e == cudaSuccess) e = e2;
  }
  return (int)e;
}

// Return persisting L2 lines to normal and give the L2 set-aside back.
extern "C" int fs_l2_persistence_reset() {
  cudaError_t e = cudaCtxResetPersistingL2Cache();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, 0);
}
