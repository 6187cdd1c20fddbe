// Chain kernels: several activation-MLP chains that share one input x [N,
// d_in], each ending in linear heads, forward and backward.
//
// chains_fwd_tiles_kernel (and, for chains too large for it, the staged
// forward below) replaces rl8_tpu/ops/fused_mlp.py:_fwd_kernel (called by
// _call_fwd, the forward of fused_chains); chains_bwd_tiles_kernel (and,
// for chains too large for it, the staged backward) replaces
// fused_mlp.py:_bwd_kernel (_fused_bwd, the TPU's recompute-based
// backward; the staged backward reads the forward's saved activations
// where they fit, below). Per
// chain, layer l computes
//   h_l = act(LN_l?(h_{l-1} @ W_l + b_l)),  h_{-1} = x,
// with flax's fast-variance LayerNorm where the layer has one: mu = mean(z),
// var = max(mean(z^2) - mu^2, 0), s = rsqrt(var + 1e-6), xhat = (z - mu) s,
// LN(z) = xhat * scale + bias; then out_j = h_{L-1} @ Wh_j + bh_j per head.
// The parameters are one flat f32 vector, per chain each layer's W [in, out],
// b, and (LayerNorm) scale and bias, then each head's W and b: fused_mlp.py's
// _flatten_params order. Each head has its own [N, hw] output; the backward
// takes each head's cotangent and returns dx [N, d_in] and the gradient of
// every parameter in the flat layout.
//
// Bound on an H100 SXM at the main path (MischievousMule: two chains of d_in
// = 7 -> 128 (LayerNorm) -> 128, heads of 3 and 1): the forward is 35,072
// multiply-adds per row, 0.29 GFLOP for a 4,096-row rollout step and 2.30
// GFLOP for a 32,768-row minibatch, against 36 bytes of input and 16 of
// output per row and ~0.14 MB of parameters: f32 FMAs bound it, 34 us at 67
// TFLOP/s for the minibatch. The backward recomputes the forward and adds the
// dh products and the weight products, ~3x the operations (6.90 GFLOP): 0.103
// ms on the CUDA cores, 0.042 ms at three TF32 products per f32 product on
// the tensor cores; its inputs and outputs are ~2.6 MB. At 2048 wide (the
// same layout, 8,441,864 parameters) a 32,768-row minibatch's forward is 552
// GFLOP (8.24 ms at 67 TFLOP/s) and its backward ~3x that; the saved
// backward (no recompute) 1,104 GFLOP of dh, dx and weight products, 6.69
// ms at three TF32 products a product on 495 TFLOP/s.
//
// Design.
// - Forward, f32 on the CUDA cores (a tensor-core forward flipped a relu
//   mask, PERF.md), each output summed in order of k.
//   - The tiled route (chains whose parameters and a 64-row tile fit a
//     block's shared memory: MischievousMule's use ~114 KB, so two
//     256-thread blocks share an SM). Block (i, c) owns chain c, loads its
//     parameters into shared memory once (cp.async) and walks the row tiles
//     i, i + groups, ...: the weights are read from L2 once per block, where
//     the first design read both chains' ~0.14 MB from L2 for every 16 rows
//     (~0.3 GB a 32,768-row launch). One chain a block rather than both
//     (~146 KB): two blocks an SM (16 warps to hide the latency of the
//     barrier-separated phases; 8 warps an SM, 32-row tiles of 128
//     threads, took 0.0996 ms against 0.0908 at 32,768 rows on an H100),
//     and a 4,096-row rollout step still gives 128 blocks.
//     Products are tile.cuh's register tiles: each thread owns 4 rows x 8
//     columns, so one 16-byte shared-memory load feeds 8 FMAs (the first
//     design issued about one load per FMA and left half its threads idle
//     at width 128). A layer up to 128 wide is one pass, and its row group's
//     16 lanes hold each of its rows in registers: its LayerNorm (flax's
//     fast variance, clamped at 0: each lane sums its 8 columns in order,
//     then an xor butterfly over the 16 lanes) and, after the last layer,
//     the narrow heads (the same sums of products) run there and write
//     straight to each head's output [N, hw]; its output replaces its input
//     in shared memory. Wider layers take passes of 128 columns between two
//     buffers, a LayerNorm a warp per row, narrow heads 4 lanes a row, and
//     wider heads the product. The activation is a template argument.
//   - The staged route (every other chain, of any width: e.g. a 768-wide
//     layer, whose tile buffers alone fill shared memory, or MischievousMule
//     at 2382 wide): one launch per layer depth over (256-column tiles,
//     128-row blocks, the chains that have that layer), chains_layer_kernel:
//     one persistent block an SM walks the tiles, a producer thread feeding
//     stage.cuh's warp-specialised ring (ws_produce: 4 stages of 32 k, each
//     weight slab one bulk copy from a copy of W_l laid out per stage,
//     tile_fwd_kernel, made once a call; each row slab one 2-D tensor-map
//     copy, swizzled, zeros past the rows and K; x first copied with rows
//     16-byte aligned where d_in is no multiple of 4)
//     and two consumer warpgroups summing in f32 (ws_consume: 8 rows x 16
//     columns a thread, fwd_product's sums; full and empty mbarriers a
//     stage, no block barrier; setmaxnreg gives the consumers the
//     producer's registers), reading h_{l-1} in place and writing h_l (or,
//     before a LayerNorm, z) to a device scratch of two buffers a chain (the
//     saving forward: one a layer, the backward's); a LayerNorm
//     needs the whole row, so chains_ln_kernel then applies it and the
//     activation in place, a warp per row. Heads narrower than 8 are warp
//     dot products in narrow_head's order (chains_heads_kernel, stage.cuh's
//     st_heads); wider heads are chains_layer_kernel products without an
//     activation. Shared memory is the ring's, whatever the width; each
//     weight slab a block stages feeds 128 rows.
//   Rows past N are zeros in shared memory and are never stored; nothing is
//   padded in device memory.
// - Backward. The TPU kernel adds every grid step's gradients into
//   VMEM-resident accumulators over a sequential grid. CUDA blocks run in
//   parallel and nothing carries over between them, so:
//   - The tiled route (chains whose parameters, their gradients and a 32-row
//     tile fit a block's shared memory: MischievousMule's use 219 KB). Block
//     (i, c) of 512 threads owns chain c and walks the row tiles i, i +
//     groups, ...: persistent blocks, as many as the card holds at once (one
//     an SM), split evenly over the chains. It loads the chain's parameters
//     into shared memory once (cp.async) and keeps their gradient
//     accumulators there, in the same padded layout. Per tile it recomputes
//     the forward (f32 FMAs in order of k: on the tensor cores it flipped a
//     relu mask, see forward_rows), keeping every h_l (and a LayerNorm's
//     xhat and s) in shared memory; then, from the top, the weight products
//     dW += h_in^T dpre and the cotangents da = (dpre_above W^T) act'(h_l),
//     in place of h_l, on the tensor cores (mma.cuh's 3xTF32; the 7-wide
//     input's dx on the CUDA cores as warp dot products), and the column sums
//     db = sum(dpre), dscale = sum(da xhat), dbias = sum(da) on the CUDA
//     cores; through a LayerNorm dxhat = da scale and dpre = s (dxhat -
//     mean(dxhat) - xhat mean(dxhat xhat)) (a warp per row). The per-row
//     activations and cotangents never reach device memory: the first design
//     wrote ~6 KB of them per row (~0.2 GB per minibatch) and read them back.
//     Each gradient element has one owner thread for every tile, so its adds
//     come in a fixed order. The block writes its gradients as one row of the
//     partials, and its rows' dx of its chain to a per-chain dx.
//   - The staged route (every other chain): a row pass through a device
//     scratch, then the weight products. Where the scratch holds every row
//     at once (rl8_chains_chunk_rows answers N) and the forward takes its
//     staged route too, the forward that autograd runs before it is a
//     saving one (rl8_chains_fwd's save, the same products and bits as the
//     forward without it, so a forward's outputs never depend on grad
//     mode): it lays out
//     the backward's workspace, makes the backward's weight copies too and
//     keeps every h_l (and a LayerNorm's xhat and s) in it, and the saved
//     backward starts from there: on this card the scratch is device memory
//     that the backward allocates anyway, where the TPU kept it in VMEM,
//     so a saved activation costs no memory and spares the forward's
//     recompute (the same kernels and sums: the same bits). Elsewhere (a
//     chunked scratch) the row pass recomputes the forward with the staged
//     forward's launches, keeping every h_l (and a LayerNorm's xhat and s)
//     in the scratch. Then, from the top, one launch
//     per step down the chains, chains_dh_kernel: dh = cot W^T by stage.cuh's
//     bwd_product (3xTF32 wgmma from big and small TF32 copies that
//     tile_bwd_kernel lays out per stage, a fresh accumulator every 32 k;
//     the heads' weights stacked side by side, their cotangents copied into
//     one slab per chain), stored as da = dh act'(h_l); through a LayerNorm,
//     chains_ln_bwd_kernel turns da into dpre = s (dxhat - mean(dxhat) -
//     xhat mean(dxhat xhat)), a warp per row, and leaves da xhat over xhat;
//     finally dx_c = dpre_0 W_0^T, a bwd_product where d_in is 8 or more and
//     warp dot products on the CUDA cores (chains_dx_kernel) below that. One
//     kind of product a kernel: one holding both spilled at 255 registers
//     (ppo.cu's earlier wide route). Then wgrad.cuh's split-K weight
//     products (128x128 3xTF32 wgmma tiles; the CUDA cores for a first
//     layer's K below 64, the narrow heads and LayerNorm's column sums)
//     over groups of rows, each group writing its own partial of every
//     parameter. The groups are bounded by rows and by a budget of
//     kPartialFloats for all partials (at 2382 wide, 11.4 M parameters,
//     five groups, 0.23 GB, where 256 groups of 128 rows would write and
//     read back 11.7 GB a launch).
//   Then sum_partials_kernel adds the partials, and sum_chain_dx_kernel the
//   chains' dx, in a fixed order. No float atomics: two launches give the
//   same bits.
// - Counts. Any number of chains, layers and heads. The tiled routes pass
//   their chains' layouts in the kernels' parameters: a launch holds up to
//   kTileChains chains (more chains take more launches, each block row of
//   the partials holding every chain's columns), each of up to kTileDepth
//   layers and kTileHeads heads; deeper chains, or chains with more heads,
//   take the staged routes. Those launch a layer depth (or a step down the
//   chains) at a time, with tables of kStJobs products or rows a launch
//   (more take more launches), and the weight products go to wgrad.cuh's
//   launch_jobs in lists. The staged backward's row scratch holds every
//   h_l, dpre_l and LayerNorm xhat_l, da_l and s_l of every chain, which
//   grows with depth times rows (MischievousMule's deepest admitted layout,
//   324 layers of 128, would take ~22 GB at 32,768 rows), so it runs over
//   chunks of whole 128-row blocks that fit kWorkspaceFloats (4 GiB) beside
//   the weight copies and the partials: per chunk the recompute, the dh
//   products, dx and the weight products, whose partials are added into
//   the gradient in chunk order. Only a single chunk is saved by the
//   forward; a chunked backward, or one behind the tiled forward,
//   recomputes (a route by shape, decided
//   before any launch).
#include <cuda.h>  // CUtensorMap and its encoder's types (the encoder is looked up at run time)
#include <cuda_runtime.h>
#include <math.h>

#include "mlp.cuh"
#include "stage.cuh"
#include "tile.cuh"
#include "wgrad.cuh"

#include <atomic>
#include <vector>

namespace {

using rl8::activate;
using rl8::FragA;
using rl8::FragB;
using rl8::Job;
using rl8::Jobs;
using rl8::kIdentity;
using rl8::kRelu;
using rl8::kTanh;

// The tiled routes' tables, passed in the kernels' parameters: a launch
// holds up to kTileChains chains (more chains take more launches), each of
// up to kTileDepth layers and kTileHeads heads. Deeper chains, or chains
// with more heads, take the staged routes, which take any count.
constexpr int kTileChains = 4;
constexpr int kTileDepth = 8;
constexpr int kTileHeads = 4;
constexpr int kNarrow = 8;  // products with fewer outputs than this are warp dot products
constexpr float kLnEps = 1e-6f;
constexpr int kMaxSmem = 232448;  // shared memory a block may use on an H100
// Rows per group of the staged backward's weight products, and the most
// groups: a minibatch of 32,768 rows makes wgrad.cuh's 4,096-row groups
// only 8, too few blocks for the card at narrow widths, and its blocks walk
// their rows in a latency-bound loop of 32-row chunks, so the chains split
// finer, as far as kPartialFloats allows.
constexpr int kGroupRows = 128;
constexpr int kMaxChainGroups = 256;
constexpr long long kPartialFloats = 64LL << 20;  // 256 MiB of partials at most
// The staged backward's workspace budget: 4 GiB, the weight copies, the
// partials and the row scratch of a chunk of rows together. Its row scratch
// keeps every h_l (and a LayerNorm's xhat, da and s) of every chain for its
// rows, which grows with depth times rows, so it runs over chunks of whole
// 128-row blocks that fit the budget, as few as fit and of equal rows.
constexpr long long kWorkspaceFloats = 1LL << 30;
// The tiled backward: threads and rows per block, the parameter blocks a
// chain's layout copies, and the most blocks over a launch's chains.
constexpr int kTileThreads = 512;
constexpr int kTileRows = 32;
constexpr int kMaxTileSegs = 2 * kTileDepth + 2 * kTileHeads;
constexpr int kMaxTileBlocks = 264;

// The chains' structure and the parameter offsets (host only; any number
// of chains, layers and heads): chain c's layer l is width[c][l] wide
// (ln[c][l]: with a LayerNorm), its head j head_w[c][j] wide, at column
// head_col[c][j] among all heads' outputs (a chain's heads are adjacent,
// chain_out[c] columns).
struct Chains {
  long long N;
  int d_in, act, n_chains, n_out;
  int max_w;  // widest layer, or d_in if wider
  int depth;  // the most layers of a chain
  std::vector<int> n_layers, n_heads, chain_out;
  std::vector<std::vector<int>> width, ln, head_w, head_col;
  std::vector<std::vector<float*>> out;         // forward: each head's output [N, hw]
  std::vector<std::vector<const float*>> dout;  // backward: each head's cotangent [N, hw]
  // Offset of each layer's W in the flat parameters (b, then a LayerNorm's
  // scale and bias follow it); index n_layers + j: head j's W.
  std::vector<std::vector<long long>> woff;
};

struct Layout {
  Chains d;
  long long P;
};

// Parses spec = [n_chains, then per chain: n_layers, (width, ln) per layer,
// n_heads, width per head] and lays the parameters out; false where the
// spec is malformed (no chain, a chain of no layer or no head, a width
// below 1). Any count is taken.
bool make_layout(long long N, int d_in, int act, const int* spec, int spec_len, Layout* L) {
  if (N <= 0 || d_in <= 0 || (act != kRelu && act != kTanh) || spec_len < 1) return false;
  Chains& d = L->d;
  d.N = N;
  d.d_in = d_in;
  d.act = act;
  int i = 0;
  auto next = [&](int* v) {
    if (i >= spec_len) return false;
    *v = spec[i++];
    return true;
  };
  if (!next(&d.n_chains) || d.n_chains < 1 || d.n_chains > spec_len) return false;
  const int C = d.n_chains;
  d.n_layers.assign(C, 0);
  d.n_heads.assign(C, 0);
  d.chain_out.assign(C, 0);
  d.width.assign(C, {});
  d.ln.assign(C, {});
  d.head_w.assign(C, {});
  d.head_col.assign(C, {});
  d.out.assign(C, {});
  d.dout.assign(C, {});
  d.woff.assign(C, {});
  long long off = 0;
  d.n_out = 0;
  d.max_w = d_in;
  d.depth = 0;
  for (int c = 0; c < C; ++c) {
    if (!next(&d.n_layers[c]) || d.n_layers[c] < 1 || d.n_layers[c] > spec_len) return false;
    const int nl = d.n_layers[c];
    d.depth = nl > d.depth ? nl : d.depth;
    d.width[c].resize(nl);
    d.ln[c].resize(nl);
    int in = d_in;
    for (int l = 0; l < nl; ++l) {
      int w, ln;
      if (!next(&w) || !next(&ln) || w < 1 || (ln != 0 && ln != 1)) return false;
      d.width[c][l] = w;
      d.ln[c][l] = ln;
      d.max_w = w > d.max_w ? w : d.max_w;
      d.woff[c].push_back(off);
      off += (long long)in * w + w + (ln ? 2LL * w : 0);
      in = w;
    }
    if (!next(&d.n_heads[c]) || d.n_heads[c] < 1 || d.n_heads[c] > spec_len) return false;
    for (int j = 0; j < d.n_heads[c]; ++j) {
      int hw;
      if (!next(&hw) || hw < 1) return false;
      d.head_w[c].push_back(hw);
      d.head_col[c].push_back(d.n_out);
      d.n_out += hw;
      d.chain_out[c] += hw;
      d.woff[c].push_back(off);
      off += (long long)in * hw + hw;
    }
    d.out[c].assign(d.n_heads[c], nullptr);
    d.dout[c].assign(d.n_heads[c], nullptr);
  }
  if (i != spec_len) return false;
  L->P = off;
  return true;
}

// Whether every chain fits the tiled routes' tables.
bool tile_tables_fit(const Chains& d) {
  for (int c = 0; c < d.n_chains; ++c) {
    if (d.n_layers[c] > kTileDepth || d.n_heads[c] > kTileHeads) return false;
  }
  return true;
}

// ------------------------------------------------------- tiled backward

// A row-major block of the flat parameters ([rows, cols] from flat) and its
// place in shared memory (rows ld apart from sm).
struct Seg {
  long long flat;
  int rows, cols, sm, ld;
};

// One chain's shared-memory layout in the tiled backward (offsets in
// floats). The parameters lie at [0, S) and their gradient accumulators, in
// the same layout, at [S, 2S): per layer W_l [in_l, w_l] (rows ldw apart),
// then its b (and LayerNorm scale and bias) as in the flat vector; then the
// heads' Ws side by side, [w_last, n_out] (rows ldh apart), and their
// biases. The row tile's activations follow.
struct TileChain {
  int L, n_out, n_heads;
  int in[kTileDepth], w[kTileDepth], ln[kTileDepth];
  int sw[kTileDepth], ldw[kTileDepth], sv[kTileDepth];
  int sh, ldh, shb, S;
  int sa[kTileDepth], lda[kTileDepth];  // h_l (then da_l, then dpre_l) [R, w_l]
  int sxh[kTileDepth];                  // LayerNorm xhat_l [R, w_l], rows lda[l] apart
  int sx, ldx, sd, ldd, ss;             // x [R, d_in], head cotangents [R, n_out], LayerNorm s [L, R]
  int n_seg;
  Seg seg[kMaxTileSegs];
  const float* dout[kTileHeads];
  int head_w[kTileHeads], head_col[kTileHeads];  // columns among the chain's heads
};

// A tiled backward launch: n_chains chains of the structure's (at most
// kTileChains), from chain `base` on; groups blocks a chain. Every launch of
// a structure has the same groups, so that each block row of the partials
// holds every parameter.
struct Tiled {
  long long N, P;
  int d_in, act, n_chains, base, groups;
  size_t smem;
  TileChain c[kTileChains];
};

// Row strides: activations 4 past a multiple of 32 (the A fragments' loads
// are then free of bank conflicts), weights a multiple of 8 that is not one
// of 16 (the B fragments' loads of a forward product are then free of them).
int act_ld(int w) { return (w + 31) / 32 * 32 + 4; }
int weight_ld(int w) {
  const int ld = (w + 7) / 8 * 8;
  return ld % 16 == 0 ? ld + 8 : ld;
}

// Lays out the tiled backward of Lo's chains (every chain's in *chains; T
// the launches' shared fields); false where a chain's parameters, gradients
// and row tile do not fit a block's shared memory, or the chain does not
// fit the tables (those chains take the staged route).
bool make_tiled(const Layout& Lo, Tiled* T, std::vector<TileChain>* chains) {
  const Chains& d = Lo.d;
  if (!tile_tables_fit(d)) return false;
  T->N = d.N;
  T->P = Lo.P;
  T->d_in = d.d_in;
  T->act = d.act;
  T->n_chains = d.n_chains < kTileChains ? d.n_chains : kTileChains;
  T->base = 0;
  chains->assign(d.n_chains, TileChain{});
  long long most = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    TileChain& t = (*chains)[c];
    t.L = d.n_layers[c];
    t.n_out = d.chain_out[c];
    t.n_heads = d.n_heads[c];
    long long off = 0;
    int n = 0, in = d.d_in;
    for (int l = 0; l < t.L; ++l) {
      const int w = d.width[c][l];
      t.in[l] = in;
      t.w[l] = w;
      t.ln[l] = d.ln[c][l];
      t.sw[l] = (int)off;
      t.ldw[l] = weight_ld(w);
      t.seg[n++] = Seg{d.woff[c][l], in, w, (int)off, t.ldw[l]};
      off += (long long)in * t.ldw[l];
      const int nv = t.ln[l] ? 3 * w : w;
      t.sv[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l] + (long long)in * w, 1, nv, (int)off, nv};
      off += nv;
      in = w;
    }
    t.sh = (int)off;
    t.ldh = weight_ld(t.n_out);
    off += (long long)in * t.ldh;
    t.shb = (int)off;
    off += t.n_out;
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = d.head_w[c][j], col = d.head_col[c][j] - d.head_col[c][0];
      t.head_w[j] = hw;
      t.head_col[j] = col;
      t.dout[j] = d.dout[c][j];
      t.seg[n++] = Seg{d.woff[c][t.L + j], in, hw, t.sh + col, t.ldh};
      t.seg[n++] = Seg{d.woff[c][t.L + j] + (long long)in * hw, 1, hw, t.shb + col, hw};
    }
    t.n_seg = n;
    off = (off + 3) / 4 * 4;
    t.S = (int)off;
    constexpr int R = kTileRows;
    long long a = 2 * off;
    t.sx = (int)a;
    t.ldx = act_ld(d.d_in);
    a += (long long)R * t.ldx;
    for (int l = 0; l < t.L; ++l) {
      t.lda[l] = act_ld(t.w[l]);
      t.sa[l] = (int)a;
      a += (long long)R * t.lda[l];
      t.sxh[l] = -1;
      if (t.ln[l]) {
        t.sxh[l] = (int)a;
        a += (long long)R * t.lda[l];
      }
    }
    t.sd = (int)a;
    t.ldd = act_ld(t.n_out);
    a += (long long)R * t.ldd;
    t.ss = (int)a;
    a += (long long)t.L * R;
    if (a * (long long)sizeof(float) + (long long)sizeof(TileChain) > kMaxSmem) return false;
    most = a > most ? a : most;
  }
  T->smem = sizeof(float) * (size_t)most;
  const long long tiles = (d.N + kTileRows - 1) / kTileRows;
  const long long cap = kMaxTileBlocks / T->n_chains;
  T->groups = (int)(tiles < cap ? tiles : cap);
  return true;
}

// -------------------------------------------------------- tiled forward

// The forward's tiled route: threads and rows per block, each thread's rows
// (tile.cuh's RT) and the threads of a row group (CG); a pass covers 8 CG
// columns of a layer.
constexpr int kFwdTileRows = 64;
constexpr int kFwdRT = 4;
constexpr int kFwdCG = 16;
constexpr int kFwdTileThreads = kFwdTileRows / kFwdRT * kFwdCG;
constexpr int kFwdPass = 8 * kFwdCG;

// One chain's shared-memory layout in the tiled forward (offsets in
// floats from the block's shared memory): per layer W_l [in_l, w_l] (rows
// ldw apart, 16-byte aligned, as tile.cuh reads them) and its b (and
// LayerNorm scale and bias); per head W [w_last, hw] (rows ldh apart) and
// b. The backward's TileChain lays the same blocks out for its mma fragments
// (rows a multiple of 8 apart, heads side by side) beside their gradients
// and a tile's activations for every layer, which the forward does not keep.
struct FwdChain {
  int L, n_heads;
  int in[kTileDepth], w[kTileDepth], ln[kTileDepth];
  int sw[kTileDepth], ldw[kTileDepth], sv[kTileDepth];
  int sh[kTileHeads], ldh[kTileHeads], shb[kTileHeads], head_w[kTileHeads];
  int narrow_heads;  // every head narrower than kNarrow
  int n_seg;
  Seg seg[kMaxTileSegs];
  float* out[kTileHeads];
};

// The tiled forward: two buffers of x's tile [R, d_in] at 0 (rows ldx
// apart; the next tile's lands while one is computed), then the activation
// buffers [R, widest layer] (rows lda apart) at sa and sb (one buffer, sa ==
// sb, where every layer is one pass), then the block's chain. A launch
// holds n_chains chains (at most kTileChains).
struct FwdTiled {
  long long N;
  int d_in, act, n_chains, groups;
  int ldx, lda, sa, sb;
  size_t smem;
  FwdChain c[kTileChains];
};

// Lays out the tiled forward of Lo's chains (every chain's in *chains; F
// the launches' shared fields); false where a chain's parameters and a row
// tile's two activation buffers do not fit a block's shared memory, or the
// chain does not fit the tables (those chains take the staged route,
// chains_layer_kernel).
bool make_fwd_tiled(const Layout& Lo, FwdTiled* F, std::vector<FwdChain>* chains) {
  constexpr int R = kFwdTileRows;
  const Chains& d = Lo.d;
  if (!tile_tables_fit(d)) return false;
  F->N = d.N;
  F->d_in = d.d_in;
  F->act = d.act;
  F->n_chains = d.n_chains < kTileChains ? d.n_chains : kTileChains;
  chains->assign(d.n_chains, FwdChain{});
  F->ldx = rl8::tile_ld(d.d_in);
  F->lda = rl8::tile_ld(d.max_w);
  // Layers of one pass each (the thread's sums live in registers until the
  // pass is done) write their output in place of their input: one buffer.
  int widest = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    for (int l = 0; l < d.n_layers[c]; ++l) widest = d.width[c][l] > widest ? d.width[c][l] : widest;
  }
  F->sa = 2 * R * F->ldx;
  F->sb = widest <= kFwdPass ? F->sa : F->sa + R * F->lda;
  const long long sp = F->sb + (long long)R * F->lda;
  auto up4 = [](long long v) { return (v + 3) / 4 * 4; };
  long long most = 0;
  for (int c = 0; c < d.n_chains; ++c) {
    FwdChain& t = (*chains)[c];
    t.L = d.n_layers[c];
    t.n_heads = d.n_heads[c];
    long long off = sp;
    int n = 0, in = d.d_in;
    for (int l = 0; l < t.L; ++l) {
      const int w = d.width[c][l];
      t.in[l] = in;
      t.w[l] = w;
      t.ln[l] = d.ln[c][l];
      t.ldw[l] = (w + 3) / 4 * 4;
      t.sw[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l], in, w, (int)off, t.ldw[l]};
      off = up4(off + (long long)in * t.ldw[l]);
      const int nv = t.ln[l] ? 3 * w : w;
      t.sv[l] = (int)off;
      t.seg[n++] = Seg{d.woff[c][l] + (long long)in * w, 1, nv, (int)off, nv};
      off = up4(off + nv);
      in = w;
    }
    t.narrow_heads = 1;
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = d.head_w[c][j];
      t.head_w[j] = hw;
      t.narrow_heads &= hw < kNarrow;
      t.ldh[j] = (hw + 3) / 4 * 4;
      t.sh[j] = (int)off;
      t.seg[n++] = Seg{d.woff[c][t.L + j], in, hw, (int)off, t.ldh[j]};
      off = up4(off + (long long)in * t.ldh[j]);
      t.shb[j] = (int)off;
      t.seg[n++] = Seg{d.woff[c][t.L + j] + (long long)in * hw, 1, hw, (int)off, hw};
      off = up4(off + hw);
      t.out[j] = d.out[c][j];
    }
    t.n_seg = n;
    if (off * (long long)sizeof(float) + (long long)sizeof(FwdChain) > kMaxSmem) return false;
    most = off > most ? off : most;
  }
  F->smem = sizeof(float) * (size_t)most;
  F->groups = (int)((d.N + R - 1) / R);
  return true;
}

// LayerNorm of the block's rows of z (rows ld apart, w wide), in place,
// followed by the activation: z = act(xhat * scale + bias), with scale and
// bias in shared memory. Warp i owns rows i RW .. i RW + RW - 1 and works
// on them at once: per row, each lane sums its strided elements in order,
// then an xor butterfly, as layer_norm_rows does for one row at a time (the
// same sums in the same order; its rows' serial shuffles were ~25% of the
// forward, kernel_variants.py's fwd_no_layer_norm).
template <int RW, int ACT>
__device__ __forceinline__ void layer_norm_tile(float* z, int ld, int w, const float* scale, const float* bias) {
  const int lane = threadIdx.x % 32;
  float* rows = z + (threadIdx.x / 32) * RW * ld;
  float s1[RW], s2[RW];
#pragma unroll
  for (int i = 0; i < RW; ++i) s1[i] = s2[i] = 0.0f;
  for (int k = lane; k < w; k += 32) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const float v = rows[i * ld + k];
      s1[i] += v;
      s2[i] = fmaf(v, v, s2[i]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  }
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const float mu = s1[i] / w;
    s1[i] = mu;
    s2[i] = rsqrtf(fmaxf(s2[i] / w - mu * mu, 0.0f) + kLnEps);
  }
  for (int k = lane; k < w; k += 32) {
    const float sc = scale[k], bi = bias[k];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      float* v = rows + i * ld + k;
      *v = activate(fmaf((*v - s1[i]) * s2[i], sc, bi), ACT);
    }
  }
}

// LayerNorm and activation of a one-pass layer's outputs in registers:
// v[r][j] is row r's column n[j] (columns past w are ignored), and the CG
// lanes of the row group (adjacent, within a warp) hold the whole row. Each
// lane sums its columns in order, then an xor butterfly over the CG lanes;
// flax's fast variance, clamped at 0, as layer_norm_tile computes it. Its
// separate pass over shared memory was ~14% of the forward
// (kernel_variants.py's fwd_no_layer_norm).
template <int RT, int CG, int ACT>
__device__ __forceinline__ void fused_layer_norm(float (&v)[RT][8], const int (&n)[8], int w, const float* scale,
                                                 const float* bias) {
  float sc[8], bi[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    sc[j] = n[j] < w ? scale[n[j]] : 0.0f;
    bi[j] = n[j] < w ? bias[n[j]] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (n[j] < w) {
        s1 += v[r][j];
        s2 = fmaf(v[r][j], v[r][j], s2);
      }
    }
#pragma unroll
    for (int off = CG / 2; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / w;
    const float s = rsqrtf(fmaxf(s2 / w - mu * mu, 0.0f) + kLnEps);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[r][j] = activate(fmaf((v[r][j] - mu) * s, sc[j], bi[j]), ACT);
  }
}

// The chain's narrow heads on the last layer's outputs in registers (rows
// q0 .. q0 + RT - 1; tile.cuh's tile_heads), each straight to its output
// [N, hw] for the rows below nr. Their separate pass over shared memory, and
// the barrier before it, were ~7% of the forward (fwd_no_heads).
template <int RT, int CG>
__device__ __forceinline__ void fused_heads(const float (&h)[RT][8], const int (&n)[8], int w, const FwdChain& t,
                                            const float* smem, long long r0, int q0, int nr) {
  for (int j = 0; j < t.n_heads; ++j) {
    const int hw = t.head_w[j];
    float* o = t.out[j] + r0 * hw;
    rl8::tile_heads<RT, CG>(h, n, w, smem + t.sh[j], t.ldh[j], smem + t.shb[j], hw, [&](int r, int q, float v) {
      if (q0 + r < nr) o[(q0 + r) * hw + q] = v;
    });
  }
}

// Copies the segments of a chain's parameters into shared memory
// (cp.async; committed by the caller): 16 bytes a copy where a segment's
// rows allow it, else 4, a row at a time for wide rows.
__device__ __forceinline__ void load_segments(const Seg* segs, int n_seg, const float* __restrict__ params,
                                              float* smem) {
  for (int q = 0; q < n_seg; ++q) {
    const Seg s = segs[q];
    const float* src = params + s.flat;
    float* dst = smem + s.sm;
    if ((s.cols & 3) == 0 && (s.flat & 3) == 0) {
      const int per_row = s.cols / 4;
      for (int i = threadIdx.x; i < s.rows * per_row; i += blockDim.x) {
        const int row = i / per_row, c = 4 * (i - row * per_row);
        rl8::cp_async16(dst + row * s.ld + c, src + (size_t)row * s.cols + c, 16);
      }
    } else if (s.cols >= 32) {
      for (int row = 0; row < s.rows; ++row) {
        for (int c = threadIdx.x; c < s.cols; c += blockDim.x) {
          rl8::cp_async4(dst + row * s.ld + c, src + (size_t)row * s.cols + c, 4);
        }
      }
    } else {
      for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
        rl8::cp_async4(dst + (i / s.cols) * s.ld + i % s.cols, src + i, 4);
      }
    }
  }
}

// Copies rows r0 .. r0 + R of x (zeros past N) to xs, rows ldx apart
// (cp.async; committed by the caller).
template <int R>
__device__ __forceinline__ void load_x(const float* __restrict__ x, long long N, int d_in, long long r0, float* xs,
                                       int ldx) {
  const int nr = (int)min((long long)R, N - r0);
  for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
    const int r = i / d_in;
    rl8::cp_async4(xs + r * ldx + (i - r * d_in), x + r0 * d_in + (r < nr ? i : 0), r < nr ? 4 : 0);
  }
}

// The tiled forward: block (i, c) owns chain c, loads its parameters into
// shared memory once (cp.async) and walks the row tiles i, i + groups, ...
// (the next tile's x in flight while one is computed); per tile each layer
// is tile.cuh's register-tiled product in passes of 128 columns (bias and
// activation on the way out), then a LayerNorm where the layer has one, and
// each head goes straight to its output [N, hw]: narrow ones 4 lanes per
// row (tile.cuh's narrow_rows), wider ones as a product. Rows past N are
// zeros in shared memory and are never stored.
template <int ACT>
__global__ void __launch_bounds__(kFwdTileThreads, 2)
    chains_fwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ params,
                            const __grid_constant__ FwdTiled F) {
  constexpr int R = kFwdTileRows, RT = kFwdRT, CG = kFwdCG;
  extern __shared__ __align__(16) float smem[];
  // The block's chain, copied from the parameters: read with indices known
  // only at run time, the parameters are generic loads on every use.
  __shared__ FwdChain t;
  for (int i = threadIdx.x; i < (int)(sizeof(FwdChain) / sizeof(int)); i += blockDim.x) {
    reinterpret_cast<int*>(&t)[i] = reinterpret_cast<const int*>(&F.c[blockIdx.y])[i];
  }
  __syncthreads();
  load_segments(t.seg, t.n_seg, params, smem);
  const int d_in = F.d_in, ldx = F.ldx, lda = F.lda;
  load_x<R>(x, F.N, d_in, (long long)blockIdx.x * R, smem, ldx);
  rl8::cp_async_commit();
  const int rg = threadIdx.x / CG, c0 = 4 * (threadIdx.x % CG), c1 = c0 + 4 * CG;

  int buf = 0;
  for (long long tile = blockIdx.x; tile * R < F.N; tile += gridDim.x, buf ^= 1) {
    const long long r0 = tile * R;
    const int nr = (int)min((long long)R, F.N - r0);
    const float* xs = smem + buf * R * ldx;
    rl8::cp_async_wait<0>();
    __syncthreads();  // x (and the parameters) landed; the last tile's heads are done
    if ((tile + gridDim.x) * R < F.N) {
      load_x<R>(x, F.N, d_in, (tile + gridDim.x) * R, smem + (buf ^ 1) * R * ldx, ldx);
      rl8::cp_async_commit();
    }
    const float* cur = xs;
    int cur_ld = ldx, cur_w = d_in;
    bool heads_done = false;
    for (int l = 0; l < t.L; ++l) {
      const int w = t.w[l], ldw = t.ldw[l], ln = t.ln[l];
      const float* W = smem + t.sw[l];
      const float* bv = smem + t.sv[l];
      float* dst = smem + ((l & 1) ? F.sb : F.sa);
      // A layer of one pass has each row in the registers of its row
      // group: its LayerNorm, and the narrow heads of the last layer, run on
      // them (fused_layer_norm, fused_heads) with no pass over shared memory.
      const bool one_pass = w <= kFwdPass;
      const bool fuse_heads = l == t.L - 1 && !ln && one_pass && t.narrow_heads;
      for (int n0 = 0; n0 < w; n0 += kFwdPass) {
        float acc[RT][8];
        rl8::tile_zero(acc);
        rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldw, cur_w, min(n0 + c0, ldw - 4),
                          min(n0 + c1, ldw - 4));
        int n[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          n[j] = n0 + (j < 4 ? c0 + j : c1 + j - 4);
          const float b = n[j] < w ? bv[n[j]] : 0.0f;
#pragma unroll
          for (int r = 0; r < RT; ++r) acc[r][j] = ln ? acc[r][j] + b : activate(acc[r][j] + b, ACT);
        }
        if (ln && one_pass) fused_layer_norm<RT, CG, ACT>(acc, n, w, bv + w, bv + 2 * w);
        if (fuse_heads) {
          fused_heads<RT, CG>(acc, n, w, t, smem, r0, rg * RT, nr);
          continue;
        }
        if (dst == cur) __syncthreads();  // in place: every thread's product has read its input
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          float* row = dst + (rg * RT + r) * lda;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int n4 = n[4 * half];
            if (n4 + 4 <= w) {
              *reinterpret_cast<float4*>(row + n4) =
                  make_float4(acc[r][4 * half], acc[r][4 * half + 1], acc[r][4 * half + 2], acc[r][4 * half + 3]);
            } else {
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (n4 + j < w) row[n4 + j] = acc[r][4 * half + j];
              }
            }
          }
        }
      }
      if (fuse_heads) {
        heads_done = true;
        break;
      }
      __syncthreads();
      if (ln && !one_pass) {
        layer_norm_tile<R * 32 / kFwdTileThreads, ACT>(dst, lda, w, bv + w, bv + 2 * w);
        __syncthreads();
      }
      cur = dst;
      cur_ld = lda;
      cur_w = w;
    }
    if (heads_done) continue;  // the next tile's barrier orders its writes after these reads
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = t.head_w[j], ldh = t.ldh[j];
      const float* W = smem + t.sh[j];
      const float* bh = smem + t.shb[j];
      float* o = t.out[j] + r0 * hw;
      if (hw < kNarrow) {
        rl8::narrow_rows<kFwdTileThreads / R>(cur, cur_ld, cur_w, W, ldh, bh, hw, [&](int r, int q, float v) {
          if (r < nr) o[r * hw + q] = v;
        });
        continue;
      }
      for (int n0 = 0; n0 < hw; n0 += kFwdPass) {
        float acc[RT][8];
        rl8::tile_zero(acc);
        rl8::tile_fma<RT>(acc, cur + rg * RT * cur_ld, cur_ld, W, ldh, cur_w, min(n0 + c0, ldh - 4),
                          min(n0 + c1, ldh - 4));
#pragma unroll
        for (int r = 0; r < RT; ++r) {
          const int row = rg * RT + r;
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int n = n0 + (q < 4 ? c0 + q : c1 + q - 4);
            if (row < nr && n < hw) o[row * hw + n] = acc[r][q] + bh[n];
          }
        }
      }
    }
  }
}

// acc[mt][nt] += sum over k < K of a(m, k) b(k, n) on the tensor cores
// (mma.cuh's 3xTF32, a fresh accumulator per k step of 8), for the warp's
// MTW m16 tiles from m0 and NTW n8 tiles from n0 (mma.cuh's fragment
// layouts); a and b return 0 outside their operands, k >= K included.
template <int MTW, int NTW, class FA, class FB>
__device__ __forceinline__ void warp_mma(float (&acc)[MTW][NTW][4], int m0, int n0, int K, FA a, FB b) {
  const int lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
#pragma unroll 2
  for (int kb = 0; kb < K; kb += 8) {
    const int k = kb + tq;
    FragB fb[NTW];
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) fb[nt].set(b(k, n0 + nt * 8 + g), b(k + 4, n0 + nt * 8 + g));
#pragma unroll
    for (int mt = 0; mt < MTW; ++mt) {
      const int m = m0 + mt * 16 + g;
      FragA fa;
      fa.set(a(m, k), a(m + 8, k), a(m, k + 4), a(m + 8, k + 4));
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) rl8::mma_3xtf32(acc[mt][nt], fa, fb[nt]);
    }
  }
}

// out(r, n, v) with v = sum over k < K of A[r, k] b(k, n), for the tile's
// rows and n < N; A in shared memory (rows lda apart). Products 8 or more
// wide run on the tensor cores, a warp per 8 columns for every row;
// narrower ones (the 7-wide input's dx) on the CUDA cores: S adjacent lanes
// per (row, column), S the largest power of two up to 32 that the block's
// threads allow, each summing every S-th k, then a shuffle reduction, all
// in a fixed order. (A warp per (row, column) left most of the block idle
// behind its serial shuffles: 0.1 ms of the 0.53 ms launch on an H100,
// kernel_variants.py's chains_no_dx.) Each output is passed to out by one
// lane, once.
template <class FB, class OUT>
__device__ __forceinline__ void row_product(const float* A, int lda, int K, int N, FB b, OUT out) {
  constexpr int R = kTileRows, MT = R / 16, n_warps = kTileThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  if (N < kNarrow) {
    int S = 32;
    while (S > 1 && S * R * N > kTileThreads) S >>= 1;
    const int part = threadIdx.x % S;
    // Whole groups of S lanes step together, so the shuffles see every lane
    // of a group (the loop's bound is rounded up to whole warps).
    const int outputs = R * N, per_pass = kTileThreads / S;
    for (int p0 = 0; p0 < outputs; p0 += per_pass) {
      const int p = p0 + threadIdx.x / S;
      const bool live = p < outputs;
      const int r = live ? p / N : 0, n = live ? p % N : 0;
      float s = 0.0f;
      if (live) {
        for (int k = part; k < K; k += S) s = fmaf(A[r * lda + k], b(k, n), s);
      }
      for (int off = S / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (live && part == 0) out(r, n, s);
    }
    return;
  }
  auto a = [&](int m, int k) { return k < K ? A[m * lda + k] : 0.0f; };
  auto bk = [&](int k, int n) { return k < K && n < N ? b(k, n) : 0.0f; };
  for (int n0 = 8 * warp; n0 < N; n0 += 8 * n_warps) {
    float acc[MT][1][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][0][e] = 0.0f;
    warp_mma<MT, 1>(acc, 0, n0, K, a, bk);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + 2 * tq + (e & 1);
        if (n < N) out(mt * 16 + g + (e >= 2 ? 8 : 0), n, acc[mt][0][e]);
      }
    }
  }
}

// G[m ldg + n] += sum over the tile's rows r of A[r lda + m] B[r ldb + n],
// for m < M and n < N, on the tensor cores: a warp per 32 x 16 block of G.
// The same warp owns a block at every tile, so each element of G has one
// owner and its adds need no barrier and come in a fixed order.
__device__ __forceinline__ void weight_product(const float* A, int lda, int M, const float* B, int ldb, int N,
                                               float* G, int ldg) {
  constexpr int n_warps = kTileThreads / 32;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, tq = lane % 4;
  const int units_n = (N + 15) / 16, units = (M + 31) / 32 * units_n;
  auto a = [&](int m, int k) { return m < M ? A[k * lda + m] : 0.0f; };
  auto b = [&](int k, int n) { return n < N ? B[k * ldb + n] : 0.0f; };
  for (int u = warp; u < units; u += n_warps) {
    const int m0 = (u / units_n) * 32, n0 = (u % units_n) * 16;
    float acc[2][2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    warp_mma<2, 2>(acc, m0, n0, kTileRows, a, b);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + mt * 16 + g + (e >= 2 ? 8 : 0), n = n0 + nt * 8 + 2 * tq + (e & 1);
          if (m < M && n < N) G[m * ldg + n] += acc[mt][nt][e];
        }
      }
    }
  }
}

// G[n] += sum over the tile's rows of B[r ldb + n] (times X[r ldb + n]
// when X is given), for n < N: a thread per column, rows in order.
__device__ __forceinline__ void column_sums(const float* B, int ldb, const float* X, int N, float* G) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    float s = 0.0f;
    if (X != nullptr) {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) s = fmaf(B[r * ldb + n], X[r * ldb + n], s);
    } else {
#pragma unroll
      for (int r = 0; r < kTileRows; ++r) s += B[r * ldb + n];
    }
    G[n] += s;
  }
}

// out[r, n] = act(sum over k < K of A[r, k] W[k, n] + b[n]) for the tile's
// rows and n < N (no activation where ln: a LayerNorm follows), A and W in
// shared memory (rows lda and ldw apart): the forward recompute, on the
// CUDA cores in f32, summed in order of k. On the tensor cores it flipped a
// relu mask that the plain version's f32 sums keep (a unit 1.6e-8 from 0:
// 3xTF32 truncates each k step's sum), and dx missed the checks by 0.025 on
// an H100 (kernel_variants.py's chains_tc_forward). Thread (q, j) owns
// column j (and j + 128, ...) of the tile's q-th group of rows: each weight
// it loads feeds a group's FMAs, and a warp's activation loads are
// broadcasts (four k at a time where K and lda allow).
__device__ __forceinline__ void forward_rows(const float* A, int lda, int K, const float* W, int ldw,
                                             const float* b, int N, float* out, int ldo, bool ln, int act) {
  constexpr int kCols = 128, kGroup = kTileRows * kCols / kTileThreads;
  const int j0 = threadIdx.x % kCols, q0 = (threadIdx.x / kCols) * kGroup;
  const bool vec = (K & 3) == 0 && (lda & 3) == 0;
  for (int n = j0; n < N; n += kCols) {
    float acc[kGroup];
#pragma unroll
    for (int r = 0; r < kGroup; ++r) acc[r] = 0.0f;
    int k = 0;
    if (vec) {
      for (; k < K; k += 4) {
        const float w0 = W[k * ldw + n], w1 = W[(k + 1) * ldw + n], w2 = W[(k + 2) * ldw + n], w3 = W[(k + 3) * ldw + n];
#pragma unroll
        for (int r = 0; r < kGroup; ++r) {
          const float4 a = *reinterpret_cast<const float4*>(A + (q0 + r) * lda + k);
          acc[r] = fmaf(a.x, w0, acc[r]);
          acc[r] = fmaf(a.y, w1, acc[r]);
          acc[r] = fmaf(a.z, w2, acc[r]);
          acc[r] = fmaf(a.w, w3, acc[r]);
        }
      }
    }
    for (; k < K; ++k) {
      const float wk = W[k * ldw + n];
#pragma unroll
      for (int r = 0; r < kGroup; ++r) acc[r] = fmaf(A[(q0 + r) * lda + k], wk, acc[r]);
    }
#pragma unroll
    for (int r = 0; r < kGroup; ++r) {
      const float v = acc[r] + b[n];
      out[(q0 + r) * ldo + n] = ln ? v : activate(v, act);
    }
  }
}

__device__ __forceinline__ float act_grad(float h, int act) {
  return act == kRelu ? (h > 0.0f ? 1.0f : 0.0f) : 1.0f - h * h;
}

// The tiled backward: block (i, c) owns chain c, holds its parameters and
// their gradient accumulators in shared memory, and walks the row tiles i,
// i + groups, ...; per tile the forward recompute, the backward and the
// weight products run on the tile's rows in shared memory. At the end the
// block writes its gradients as row i of the partials (the chain's columns)
// and has written its tiles' dx of the chain to dxc [n_chains, N, d_in].
__global__ void __launch_bounds__(kTileThreads, 1)
    chains_bwd_tiles_kernel(const float* __restrict__ x, const float* __restrict__ params,
                            float* __restrict__ partials, float* __restrict__ dxc, const __grid_constant__ Tiled T) {
  constexpr int R = kTileRows, n_warps = kTileThreads / 32;
  extern __shared__ __align__(16) float smem[];
  // The block's chain, copied from the parameters: read with indices known
  // only at run time, the parameters are generic loads on every use.
  __shared__ TileChain t;
  for (int i = threadIdx.x; i < (int)(sizeof(TileChain) / sizeof(int)); i += blockDim.x) {
    reinterpret_cast<int*>(&t)[i] = reinterpret_cast<const int*>(&T.c[blockIdx.y])[i];
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, act = T.act, d_in = T.d_in;
  float* Ws = smem;
  float* Gs = smem + t.S;
  for (int q = 0; q < t.n_seg; ++q) {
    const Seg s = t.seg[q];
    for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
      rl8::cp_async4(Ws + s.sm + (i / s.cols) * s.ld + i % s.cols, params + s.flat + i, 4);
    }
  }
  rl8::cp_async_commit();
  for (int i = threadIdx.x; i < t.S; i += blockDim.x) Gs[i] = 0.0f;
  rl8::cp_async_wait<0>();
  __syncthreads();
  float* xs = smem + t.sx;
  float* ds = smem + t.sd;
  float* svals = smem + t.ss;
  float* dxo = dxc + (size_t)(T.base + blockIdx.y) * T.N * d_in;

  for (long long tile = blockIdx.x; tile * R < T.N; tile += gridDim.x) {
    const long long r0 = tile * R;
    const int nr = (int)min((long long)R, T.N - r0);
    for (int i = threadIdx.x; i < R * d_in; i += blockDim.x) {
      const int r = i / d_in;
      xs[r * t.ldx + i % d_in] = r < nr ? x[r0 * d_in + i] : 0.0f;
    }
    for (int j = 0; j < t.n_heads; ++j) {
      const int hw = t.head_w[j];
      for (int i = threadIdx.x; i < R * hw; i += blockDim.x) {
        const int r = i / hw;
        ds[r * t.ldd + t.head_col[j] + i % hw] = r < nr ? t.dout[j][r0 * hw + i] : 0.0f;
      }
    }
    __syncthreads();

    // Forward, each layer's output h_l (a LayerNorm layer's xhat and s too).
    for (int l = 0; l < t.L; ++l) {
      const float* in = l == 0 ? xs : smem + t.sa[l - 1];
      const int ld_in = l == 0 ? t.ldx : t.lda[l - 1];
      float* h = smem + t.sa[l];
      const int ld = t.lda[l], w = t.w[l], ldw = t.ldw[l], ln = t.ln[l];
      const float* W = Ws + t.sw[l];
      const float* bv = Ws + t.sv[l];
      forward_rows(in, ld_in, t.in[l], W, ldw, bv, w, h, ld, ln, act);
      __syncthreads();
      if (ln) {
        float* xh = smem + t.sxh[l];
        for (int r = warp; r < R; r += n_warps) {
          float* row = h + r * ld;
          float s1 = 0.0f, s2 = 0.0f;
          for (int k = lane; k < w; k += 32) {
            const float v = row[k];
            s1 += v;
            s2 = fmaf(v, v, s2);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
            s2 += __shfl_xor_sync(0xffffffffu, s2, off);
          }
          const float mu = s1 / w;
          const float s = rsqrtf(fmaxf(s2 / w - mu * mu, 0.0f) + kLnEps);
          for (int k = lane; k < w; k += 32) {
            const float xv = (row[k] - mu) * s;
            xh[r * ld + k] = xv;
            row[k] = activate(fmaf(xv, bv[w + k], bv[2 * w + k]), act);
          }
          if (lane == 0) svals[l * R + r] = s;
        }
        __syncthreads();
      }
    }

    // Backward from the top. cot is the cotangent of the layer above's
    // pre-activation (first the heads' outputs), rows ldc apart and nc
    // wide; Wc (rows ldwc apart), Gw and Gb that layer's weights and
    // gradients. At l = -1 the layer above is layer 0 and its input x.
    const float* cot = ds;
    int ldc = t.ldd, nc = t.n_out, ldwc = t.ldh;
    const float* Wc = Ws + t.sh;
    float* Gw = Gs + t.sh;
    float* Gb = Gs + t.shb;
    for (int l = t.L - 1; l >= -1; --l) {
      const float* hin = l >= 0 ? smem + t.sa[l] : xs;
      const int ld_in = l >= 0 ? t.lda[l] : t.ldx, in_w = l >= 0 ? t.w[l] : d_in;
      weight_product(hin, ld_in, in_w, cot, ldc, nc, Gw, ldwc);
      column_sums(cot, ldc, nullptr, nc, Gb);
      if (l < 0) {
        // This chain's dx = dpre_0 W_0^T (x is not overwritten).
        row_product(cot, ldc, nc, d_in, [&](int k, int n) { return Wc[n * ldwc + k]; },
                    [&](int r, int n, float v) {
                      if (r < nr) dxo[(r0 + r) * d_in + n] = v;
                    });
        break;
      }
      __syncthreads();  // h_l is read above and overwritten below
      // da_l = (cot Wc^T) act'(h_l), in place of h_l.
      float* h = smem + t.sa[l];
      const int ld = t.lda[l], w = t.w[l];
      row_product(cot, ldc, nc, w, [&](int k, int n) { return Wc[n * ldwc + k]; },
                  [&](int r, int n, float v) { h[r * ld + n] = v * act_grad(h[r * ld + n], act); });
      __syncthreads();
      if (t.ln[l]) {
        // dscale = sum(da xhat) and dbias = sum(da); then per row dxhat =
        // da scale and dpre = s (dxhat - mean(dxhat) - xhat mean(dxhat
        // xhat)), in place.
        const float* bv = Ws + t.sv[l];
        const float* xh = smem + t.sxh[l];
        column_sums(h, ld, xh, w, Gs + t.sv[l] + w);
        column_sums(h, ld, nullptr, w, Gs + t.sv[l] + 2 * w);
        __syncthreads();
        for (int r = warp; r < R; r += n_warps) {
          float* row = h + r * ld;
          const float* xr = xh + r * ld;
          float m1 = 0.0f, m2 = 0.0f;
          for (int k = lane; k < w; k += 32) {
            const float dxh = row[k] * bv[w + k];
            m1 += dxh;
            m2 = fmaf(dxh, xr[k], m2);
          }
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            m1 += __shfl_xor_sync(0xffffffffu, m1, off);
            m2 += __shfl_xor_sync(0xffffffffu, m2, off);
          }
          m1 /= w;
          m2 /= w;
          const float s = svals[l * R + r];
          for (int k = lane; k < w; k += 32) row[k] = s * (row[k] * bv[w + k] - m1 - xr[k] * m2);
        }
        __syncthreads();
      }
      cot = h;
      ldc = ld;
      nc = w;
      ldwc = t.ldw[l];
      Wc = Ws + t.sw[l];
      Gw = Gs + t.sw[l];
      Gb = Gs + t.sv[l];
    }
    __syncthreads();  // the next tile reuses every buffer
  }
  float* out = partials + (size_t)blockIdx.x * T.P;
  for (int q = 0; q < t.n_seg; ++q) {
    const Seg s = t.seg[q];
    for (int i = threadIdx.x; i < s.rows * s.cols; i += blockDim.x) {
      out[s.flat + i] = Gs[s.sm + (i / s.cols) * s.ld + i % s.cols];
    }
  }
}

// dx = sum over chains of dxc[c] (chain c's at c * stride), in chain order.
__global__ void sum_chain_dx_kernel(const float* __restrict__ dxc, int n_chains, long long stride, long long n,
                                    float* __restrict__ dx) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = dxc[i];
    for (int c = 1; c < n_chains; ++c) s += dxc[(size_t)c * stride + i];
    dx[i] = s;
  }
}

// ------------------------------------------------------------ staged route

constexpr int kStJobs = 16;      // products (or row jobs) a staged launch's table holds; more take more launches
constexpr int kRowThreads = 256;  // the row kernels: a warp per row
constexpr int kRowRows = 32;      // rows a block of chains_ln_kernel, chains_ln_bwd_kernel
constexpr int kHeadRows = 8;      // rows a block of chains_heads_kernel, chains_dx_kernel

inline long long round4(long long v) { return (v + 3) / 4 * 4; }

// Where the staged route's operands live in its workspace (floats from its
// start, every slab 16-byte aligned), per chain: copies of W_l in
// fwd_product's layout (fwd) and, for the backward's dh products, in
// bwd_product's (big and small halves: W_l for dh_{l-1} where l >= 1, and
// for dx at l = 0 where d_in >= kNarrow; at index L the heads' weights
// stacked side by side, [w_last, chain_out], in `stack`); copies of the
// heads at least kNarrow wide (forward); the activations h_l [rows, ld_l]
// (forward: two buffers a chain, ld its widest layer, layer l in buffer l %
// 2; backward: one a layer) and, backward, dpre_l, a LayerNorm layer's
// xhat_l and da_l [rows, ld_l] and s_l [rows], and the heads' cotangents
// side by side [rows, ld_out]; x's rows with their stride rounded to 16
// bytes, xpad [rows, round4(d_in)] (the first layers' tensor maps read
// them there where x's own stride or address allows none). Then,
// backward, each chain's dx [rows, d_in] and the weight products'
// partials [groups, P]; -1 where a slab is not used. The forward's rows are N; the backward's a chunk of `chunk` rows
// (whole 128-row blocks, or N), which its passes walk in order. The saved
// layout (the saving forward's and the saved backward's, where the chunk
// is N) is the backward's with the wide heads' forward copies after the
// partials, so that every other slab lies where the backward's does.
struct StagedChain {
  std::vector<long long> fwd, big, small, head;  // big, small: L + 1 entries
  long long stack, dout;
  std::vector<long long> h, dpre, xhat, da, s;
  std::vector<int> ld;
  int ld_out;
};

struct Staged {
  std::vector<StagedChain> c;
  long long xpad, dxc, partials, chunk, floats;
  int groups, depth;  // groups: the most groups of rows of a chunk's weight products; depth: the most layers of a chain
};

// The staged route's layout (saved: the saved layout, a backward one);
// false (backward) where the weight copies and the partials leave no room
// in kWorkspaceFloats for one 128-row block.
bool make_staged(const Layout& Lo, bool backward, Staged* S, bool saved = false) {
  const Chains& d = Lo.d;
  const long long N = d.N;
  long long off = 0, slabs = 0;
  auto take = [&](long long floats) {
    const long long at = off;
    off += round4(floats);
    return at;
  };
  S->depth = d.depth;
  S->c.assign(d.n_chains, StagedChain{});
  long long per_row = round4(d.d_in) + (backward ? (long long)d.n_chains * d.d_in : 0);
  for (int c = 0; c < d.n_chains; ++c) {
    StagedChain& t = S->c[c];
    const int L = d.n_layers[c];
    t.fwd.assign(L, -1);
    t.big.assign(L + 1, -1);
    t.small.assign(L + 1, -1);
    t.head.assign(d.n_heads[c], -1);
    int in = d.d_in, widest = 0;
    for (int l = 0; l < L; ++l) {
      const int w = d.width[c][l];
      widest = w > widest ? w : widest;
      t.fwd[l] = take(rl8::fwd_copy_floats(in, w));
      if (backward && (l > 0 || in >= kNarrow)) {
        t.big[l] = take(rl8::bwd_copy_floats(w, in));
        t.small[l] = take(rl8::bwd_copy_floats(w, in));
      }
      in = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j];
      if (!backward && hw >= kNarrow) t.head[j] = take(rl8::fwd_copy_floats(in, hw));
    }
    t.stack = -1;
    if (backward) {
      t.stack = take((long long)in * d.chain_out[c]);
      t.big[L] = take(rl8::bwd_copy_floats(d.chain_out[c], in));
      t.small[L] = take(rl8::bwd_copy_floats(d.chain_out[c], in));
    }
    t.ld.resize(L);
    for (int l = 0; l < L; ++l) {
      t.ld[l] = (int)round4(backward ? d.width[c][l] : widest);
      if (backward) {
        per_row += 2LL * t.ld[l] + (d.ln[c][l] ? 2LL * t.ld[l] + 1 : 0);
        slabs += d.ln[c][l] ? 5 : 2;
      }
    }
    t.ld_out = (int)round4(d.chain_out[c]);
    if (backward) per_row += t.ld_out;
  }
  S->groups = 0;
  S->chunk = N;
  long long part = 0;
  if (backward) {
    long long g = (N + kGroupRows - 1) / kGroupRows;
    const long long cap = kPartialFloats / Lo.P;
    g = g > kMaxChainGroups ? kMaxChainGroups : g;
    g = g > cap ? cap : g;
    g = g < 1 ? 1 : g;
    S->groups = (int)g;
    part = g * Lo.P;
    // The copies, the partials and every slab's rounding to 16 bytes.
    const long long fixed = off + part + 4 * (slabs + 2 * (long long)d.n_chains + 2);
    if (fixed >= kWorkspaceFloats) return false;
    const long long fit = (kWorkspaceFloats - fixed) / per_row / rl8::kStRows * rl8::kStRows;
    if (fit < N) {
      if (fit < rl8::kStRows) return false;
      // As few chunks as fit, of equal rows (whole row blocks).
      const long long chunks = (N + fit - 1) / fit;
      S->chunk = ((N + chunks - 1) / chunks + rl8::kStRows - 1) / rl8::kStRows * rl8::kStRows;
    }
  }
  const long long R = S->chunk;
  for (int c = 0; c < d.n_chains; ++c) {
    StagedChain& t = S->c[c];
    const int L = d.n_layers[c];
    t.h.assign(L, -1);
    t.dpre.assign(L, -1);
    t.xhat.assign(L, -1);
    t.da.assign(L, -1);
    t.s.assign(L, -1);
    for (int l = 0; l < L; ++l) {
      t.h[l] = backward || l < 2 ? take(R * t.ld[l]) : t.h[l - 2];
      if (backward) {
        t.dpre[l] = take(R * t.ld[l]);
        if (d.ln[c][l]) {
          t.xhat[l] = take(R * t.ld[l]);
          t.da[l] = take(R * t.ld[l]);
          t.s[l] = take(R);
        }
      }
    }
    t.dout = backward ? take(R * t.ld_out) : -1;
  }
  S->xpad = take(R * round4(d.d_in));
  S->dxc = S->partials = -1;
  if (backward) {
    S->dxc = take((long long)d.n_chains * R * d.d_in);
    S->partials = take(part);
  }
  for (int c = 0; saved && c < d.n_chains; ++c) {
    const int in = d.width[c][d.n_layers[c] - 1];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      if (d.head_w[c][j] >= kNarrow) S->c[c].head[j] = take(rl8::fwd_copy_floats(in, d.head_w[c][j]));
    }
  }
  S->floats = off;
  return true;
}

// The item of a launch's table at an index known only at run time,
// selected with constant indices so the table stays in the parameter bank.
template <class T, int M>
__device__ __forceinline__ T select_item(const T (&items)[M], int index) {
  T v = items[0];
#pragma unroll
  for (int q = 1; q < M; ++q) {
    if (q == index) v = items[q];
  }
  return v;
}

// One product of chains_layer_kernel: out = act(in W + b), in [rows, K]
// (rows ld_in apart), W a copy in fwd_product's layout, out [rows, N] (rows
// ld_out apart); act is kIdentity before a LayerNorm and for a head. The
// launch's map[] holds a tensor map of `in` (ld_in a multiple of 4, in
// 16-byte aligned).
struct StProduct {
  const float* in;
  const float* w;
  const float* b;
  float* out;
  long long ld_in, ld_out;
  int K, N, act;
};

struct StProducts {
  CUtensorMap map[kStJobs];
  StProduct p[kStJobs];
  long long rows;
  int gx, gy, n;  // column tiles, row blocks and products
};
static_assert(sizeof(StProducts) <= 4096, "a launch's table fits the kernel parameters");

// out = act(acc + b) of a tile's outputs (acc[h][i][j]: row rg + 16 i,
// column n0 + 128 h + c0 + j for j < 4, n0 + 128 h + c1 + j - 4 after),
// rows below nr and columns below p.N; four adjacent columns as one
// 16-byte store where out allows it.
template <int RT>
__device__ __forceinline__ void store_tile(const StProduct& p, float* out, int nr, int n0, const float (&acc)[2][RT][8],
                                           int rg, int c0, int c1) {
  const bool vec = p.ld_out % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = n0 + 128 * h + (q == 0 ? c0 : c1);
      if (col >= p.N) continue;
      float bj[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bj[j] = col + j < p.N ? __ldg(p.b + col + j) : 0.0f;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int r = rg + 16 * i;
        if (r >= nr) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) v[j] = activate(acc[h][i][4 * q + j] + bj[j], p.act);
        float* o = out + (long long)r * p.ld_out + col;
        if (vec && col + 4 <= p.N) {
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col + j < p.N) o[j] = v[j];
          }
        }
      }
    }
  }
}

// The staged forward's products on stage.cuh's warp-specialised ring:
// blocks walk the launch's tiles t = blockIdx.x, + gridDim.x, ... (one
// block an SM, persistent, so that a tile's epilogue stores overlap the
// next tile's copies); tile t is column tile t % gx (256 columns), row
// block (t / gx) % gy (128 rows) of product t / (gx gy). One producer
// thread fills the ring (ws_produce), the two consumer warpgroups sum each output
// in order of k from 0 in f32 (ws_consume, fwd_product's sums), then add
// the bias and apply the activation (store_tile).
__global__ void __launch_bounds__(rl8::kWsThreads, 1) chains_layer_kernel(const __grid_constant__ StProducts ps) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  rl8::WsRing ring = rl8::ws_ring_init(st_smem);
  const long long per_product = (long long)ps.gx * ps.gy, tiles = per_product * ps.n;
  // Each role walks the tiles in its own loop, so that its register budget
  // (setmaxnreg) holds for all of its code.
  if (threadIdx.x < rl8::kWsThreads - rl8::kWsConsumers) {
    rl8::ws_producer_regs();
    if (threadIdx.x != 0) return;
    for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int z = (int)(t / per_product), x = (int)(t % per_product % ps.gx);
      const long long r0 = t % per_product / ps.gx * R;
      const StProduct p = select_item(ps.p, z);
      if (x * rl8::kStFwdPass >= p.N) continue;
      rl8::ws_produce(ring, &ps.map[z], p.K, (int)r0,
                      p.w + (long long)x * ((p.K + rl8::kStK - 1) / rl8::kStK) * rl8::kStFwdWFloats);
    }
    return;
  }
  rl8::ws_consumer_regs();
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int z = (int)(t / per_product), x = (int)(t % per_product % ps.gx);
    const long long r0 = t % per_product / ps.gx * R;
    const StProduct p = select_item(ps.p, z);
    const int n0 = x * rl8::kStFwdPass;
    if (n0 >= p.N) continue;
    const int nr = (int)min((long long)R, ps.rows - r0);
    float* out = p.out + r0 * p.ld_out;
    rl8::ws_consume(ring, p.K, [&](const auto& acc, int rg, int c0, int c1) {
      store_tile(p, out, nr, n0, acc, rg, c0, c1);
    });
  }
}

// One chain's LayerNorm rows for chains_ln_kernel: z [rows, w] (rows ld
// apart), in place; with xhat and s (the backward's recompute) each row's
// xhat [rows, w] (rows ld apart) and s [rows].
struct LnRows {
  float* z;
  const float* scale;
  const float* bias;
  float* xhat;
  float* s;
  long long ld;
  int w;
};

struct LnLaunch {
  LnRows j[kStJobs];
  long long rows;
  int act;
};

// z = act(xhat * scale + bias) for kRowRows rows a block (blockIdx.x) of
// chain job blockIdx.y, a warp per row: each lane sums its strided elements
// in order, then an xor butterfly (the same bits in every lane); flax's
// fast variance, clamped at 0.
__global__ void __launch_bounds__(kRowThreads) chains_ln_kernel(const __grid_constant__ LnLaunch ls) {
  const LnRows j = select_item(ls.j, blockIdx.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kRowRows; i += kRowThreads / 32) {
    const long long r = (long long)blockIdx.x * kRowRows + i;
    if (r >= ls.rows) break;
    float* row = j.z + r * j.ld;
    float s1 = 0.0f, s2 = 0.0f;
    for (int k = lane; k < j.w; k += 32) {
      const float v = row[k];
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mu = s1 / j.w;
    const float s = rsqrtf(fmaxf(s2 / j.w - mu * mu, 0.0f) + kLnEps);
    for (int k = lane; k < j.w; k += 32) {
      const float xh = (row[k] - mu) * s;
      if (j.xhat != nullptr) j.xhat[r * j.ld + k] = xh;
      row[k] = activate(fmaf(xh, __ldg(j.scale + k), __ldg(j.bias + k)), ls.act);
    }
    if (j.s != nullptr && lane == 0) j.s[r] = s;
  }
}

// One narrow head for chains_heads_kernel: out [rows, hw] = in W + b, in
// [rows, K] (rows ld_in apart), W [K, hw] and b as stored.
struct HeadRows {
  const float* in;
  const float* W;
  float* out;
  long long ld_in;
  int K, hw;
};

struct HeadLaunch {
  HeadRows j[kStJobs];
  long long rows;
};

// The heads narrower than kNarrow over blocks of kHeadRows rows (blockIdx.x;
// blockIdx.y the head): stage.cuh's st_heads, narrow_head's sums.
__global__ void __launch_bounds__(rl8::kStThreads) chains_heads_kernel(const __grid_constant__ HeadLaunch hs) {
  const HeadRows j = select_item(hs.j, blockIdx.y);
  const long long r0 = (long long)blockIdx.x * kHeadRows;
  const int nr = (int)min((long long)kHeadRows, hs.rows - r0);
  rl8::st_heads(j.in + r0 * j.ld_in, j.ld_in, j.K, j.W, j.W + (size_t)j.K * j.hw, j.hw, j.out + r0 * j.hw, j.hw, 0,
                nr);
}

// One product of chains_dh_kernel: out = (a W^T) act'(h), or a W^T where h
// is null; a [rows, K] (rows lda apart), W's big and small TF32 halves in
// bwd_product's layout (units x K), out and h [rows, units] (rows ldo and
// ldh apart).
struct DhProduct {
  const float* a;
  const float* big;
  const float* small;
  const float* h;
  float* out;
  long long lda, ldh, ldo;
  int K, units;
};

struct DhLaunch {
  DhProduct j[kStJobs];
  long long rows;
  int act;
};

// The staged backward's dh products: blockIdx.x the first 128-row block,
// which steps by gridDim.x, blockIdx.y the product; stage.cuh's
// bwd_product (3xTF32 wgmma, a fresh accumulator every 32 k), every unit of
// the block's rows.
__global__ void __launch_bounds__(rl8::kStThreads, 1) chains_dh_kernel(const __grid_constant__ DhLaunch ds) {
  constexpr int R = rl8::kStRows;
  extern __shared__ __align__(128) float st_smem[];
  const DhProduct p = select_item(ds.j, blockIdx.y);
  const long long tiles = (ds.rows + R - 1) / R;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long r0 = t * R;
    const int nr = (int)min((long long)R, ds.rows - r0);
    const float* a = p.a + r0 * p.lda;
    const float* h = p.h == nullptr ? nullptr : p.h + r0 * p.ldh;
    float* out = p.out + r0 * p.ldo;
    const rl8::StRows rows{a, p.lda, p.K, nr, rl8::st_vec(a, p.lda)};
    rl8::bwd_product(rows, p.big, p.small, p.units, st_smem, [&](int r, int u, float v) {
      if (r < nr) out[r * p.ldo + u] = h == nullptr ? v : v * act_grad(h[r * p.ldh + u], ds.act);
    });
  }
}

// One LayerNorm layer of chains_ln_bwd_kernel (each [rows, w], rows ld
// apart): its da, xhat and s from the recompute, its scale, and dpre.
struct LnBwdRows {
  const float* da;
  float* xhat;
  const float* s;
  const float* scale;
  float* dpre;
  long long ld;
  int w;
};

struct LnBwdLaunch {
  LnBwdRows j[kStJobs];
  long long rows;
};

// Per row, dxhat = da scale and dpre = s (dxhat - mean(dxhat) - xhat
// mean(dxhat xhat)); xhat is overwritten with da xhat (the column sums of
// dscale read it). A warp per row, kRowRows rows a block: each lane sums
// its strided elements in order, then an xor butterfly.
__global__ void __launch_bounds__(kRowThreads) chains_ln_bwd_kernel(const __grid_constant__ LnBwdLaunch ls) {
  const LnBwdRows j = select_item(ls.j, blockIdx.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int i = warp; i < kRowRows; i += kRowThreads / 32) {
    const long long r = (long long)blockIdx.x * kRowRows + i;
    if (r >= ls.rows) break;
    const float* da = j.da + r * j.ld;
    float* xh = j.xhat + r * j.ld;
    float m1 = 0.0f, m2 = 0.0f;
    for (int k = lane; k < j.w; k += 32) {
      const float dxh = da[k] * __ldg(j.scale + k);
      m1 += dxh;
      m2 = fmaf(dxh, xh[k], m2);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m1 += __shfl_xor_sync(0xffffffffu, m1, off);
      m2 += __shfl_xor_sync(0xffffffffu, m2, off);
    }
    m1 /= j.w;
    m2 /= j.w;
    const float s = j.s[r];
    float* dpre = j.dpre + r * j.ld;
    for (int k = lane; k < j.w; k += 32) {
      const float dv = da[k], xv = xh[k];
      dpre[k] = s * (dv * __ldg(j.scale + k) - m1 - xv * m2);
      xh[k] = dv * xv;
    }
  }
}

// One chain's dx for chains_dx_kernel: out [rows, d_in] = a W^T, a
// [rows, K] (rows lda apart), W [d_in, K] as stored.
struct DxRows {
  const float* a;
  const float* W;
  float* out;
  long long lda;
  int K;
};

struct DxLaunch {
  DxRows j[kStJobs];
  long long rows;
  int d_in;
};

// dx of an input narrower than kNarrow on the CUDA cores, kHeadRows rows a
// block (blockIdx.x; blockIdx.y the chain): a warp per (row, input) pair,
// lane l summing k = l, l + 32, ... in order, then an xor butterfly.
__global__ void __launch_bounds__(rl8::kStThreads) chains_dx_kernel(const __grid_constant__ DxLaunch xs) {
  const DxRows j = select_item(xs.j, blockIdx.y);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * kHeadRows;
  const int nr = (int)min((long long)kHeadRows, xs.rows - r0);
  for (int q = warp; q < nr * xs.d_in; q += rl8::kStThreads / 32) {
    const int r = q / xs.d_in, n = q % xs.d_in;
    const float* a = j.a + (r0 + r) * j.lda;
    const float* W = j.W + (size_t)n * j.K;
    float s = 0.0f;
#pragma unroll 4
    for (int k = lane; k < j.K; k += 32) s = fmaf(a[k], __ldg(W + k), s);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) j.out[(r0 + r) * xs.d_in + n] = s;
  }
}

// A copy of src [rows, cols] (contiguous) into dst, rows ld apart.
struct Copy2d {
  const float* src;
  float* dst;
  long long rows, ld;
  int cols;
};

struct CopyLaunch {
  Copy2d j[kStJobs];
};

// The copies (blockIdx.y), a thread an element, grid-stride.
__global__ void __launch_bounds__(rl8::kWgThreads) chains_copy_kernel(const __grid_constant__ CopyLaunch cs) {
  const Copy2d j = select_item(cs.j, blockIdx.y);
  const long long total = j.rows * j.cols;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    j.dst[(i / j.cols) * j.ld + i % j.cols] = j.src[i];
  }
}

// A launch's table filled item by item: whenever kStJobs items are in,
// and at the end (flush), `fire(table, n)` launches them.
template <class Table, class Item>
struct Batch {
  Table t;
  int n = 0;
  template <class Fire>
  cudaError_t add(const Item& item, Fire fire) {
    t.j[n++] = item;
    return n == kStJobs ? flush(fire) : cudaSuccess;
  }
  template <class Fire>
  cudaError_t flush(Fire fire) {
    if (n == 0) return cudaSuccess;
    const cudaError_t err = fire(t, n);
    n = 0;
    return err;
  }
};

cudaError_t copy_2d(const CopyLaunch& cs, int n, long long most, cudaStream_t s) {
  if (n == 0) return cudaSuccess;
  chains_copy_kernel<<<dim3(rl8::grid_for(most), n), rl8::kWgThreads, 0, s>>>(cs);
  return cudaGetLastError();
}

// Copies items of Copy2d, kStJobs a launch.
struct Copies {
  Batch<CopyLaunch, Copy2d> b;
  long long most = 0;
  cudaStream_t s;
  auto fire() {
    return [this](const CopyLaunch& t, int n) {
      const cudaError_t err = copy_2d(t, n, most, s);
      most = 0;
      return err;
    };
  }
  cudaError_t add(const Copy2d& c) {
    most = c.rows * c.cols > most ? c.rows * c.cols : most;
    return b.add(c, fire());
  }
  cudaError_t flush() { return b.flush(fire()); }
};

// The staged kernels' shared memory (stage.cuh's rings), set once a
// device (of the first 64; on every call past them).
cudaError_t staged_attributes(int device) {
  static std::atomic<unsigned long long> done{0};
  const unsigned long long bit = device < 64 ? 1ull << device : 0;
  if (done.load() & bit) return cudaSuccess;
  cudaError_t err =
      cudaFuncSetAttribute(chains_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rl8::kWsSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(chains_dh_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)rl8::kStBwdSmem);
  }
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

// The SMs of a device, asked once a device (of the first 64).
cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> known[64];
  if (device >= 0 && device < 64 && (*sms = known[device].load()) > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && device >= 0 && device < 64) known[device].store(*sms);
  return err;
}

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime
// (so the library links nothing beyond the runtime), or null.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault,
                                                             &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(f) : nullptr;
  }();
  return fn;
}

// A tensor map of rows [rows, K] at p (rows ld floats apart) in boxes of
// kStRows rows x kWsK columns, reading zeros outside it, swizzled over each
// box row's bytes (ws_produce's rows, stage.cuh's ws_swizzle); false where
// it cannot be made (ld no multiple of 4, p not 16-byte aligned). The maps
// a thread encoded last are kept (an encode costs microseconds of host
// time, and the workspace and its activations come back at the same
// addresses call after call), the oldest replaced first.
bool rows_map(CUtensorMap* map, const float* p, long long rows, int K, long long ld) {
  struct Key {
    const float* p;
    long long rows, ld;
    int K;
  };
  constexpr int kKept = 64;
  thread_local Key keys[kKept] = {};
  thread_local CUtensorMap maps[kKept];
  thread_local int next = 0;
  for (int i = 0; i < kKept; ++i) {
    if (keys[i].p == p && keys[i].rows == rows && keys[i].ld == ld && keys[i].K == K) {
      *map = maps[i];
      return true;
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr || ld % 4 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)rl8::kWsK, (cuuint32_t)rl8::kStRows};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(p), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, rl8::kWsK == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS) {
    return false;
  }
  keys[next] = Key{p, rows, ld, K};
  maps[next] = *map;
  next = (next + 1) % kKept;
  return true;
}

// The weight copies of the staged route (make_staged's fwd, head, big and
// small; the heads' stack first).
cudaError_t staged_copies(const float* params, float* ws, const Layout& Lo, const Staged& S, cudaStream_t s) {
  const Chains& d = Lo.d;
  Copies stack;
  stack.s = s;
  cudaError_t err;
  for (int c = 0; c < d.n_chains; ++c) {
    const StagedChain& t = S.c[c];
    const int L = d.n_layers[c];
    int in = d.d_in;
    for (int l = 0; l < L; ++l) {
      const int w = d.width[c][l];
      const float* W = params + d.woff[c][l];
      rl8::tile_fwd_kernel<<<rl8::st_copy_grid(rl8::fwd_copy_floats(in, w)), rl8::kStThreads, 0, s>>>(
          W, w, in, w, 0, ws + t.fwd[l]);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
      if (t.big[l] >= 0) {
        rl8::tile_bwd_kernel<<<rl8::st_copy_grid(rl8::bwd_copy_floats(w, in)), rl8::kStThreads, 0, s>>>(
            W, w, w, in, ws + t.big[l], ws + t.small[l]);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
      in = w;
    }
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j];
      const float* W = params + d.woff[c][L + j];
      if (t.head[j] >= 0) {
        rl8::tile_fwd_kernel<<<rl8::st_copy_grid(rl8::fwd_copy_floats(in, hw)), rl8::kStThreads, 0, s>>>(
            W, hw, in, hw, 0, ws + t.head[j]);
        if ((err = cudaGetLastError()) != cudaSuccess) return err;
      }
      if (t.stack >= 0) {
        err = stack.add(Copy2d{W, ws + t.stack + (d.head_col[c][j] - d.head_col[c][0]), in, d.chain_out[c], hw});
        if (err != cudaSuccess) return err;
      }
    }
  }
  if ((err = stack.flush()) != cudaSuccess) return err;
  for (int c = 0; c < d.n_chains; ++c) {
    const StagedChain& t = S.c[c];
    if (t.stack < 0) continue;
    const int L = d.n_layers[c], n_out = d.chain_out[c], w = d.width[c][L - 1];
    rl8::tile_bwd_kernel<<<rl8::st_copy_grid(rl8::bwd_copy_floats(n_out, w)), rl8::kStThreads, 0, s>>>(
        ws + t.stack, n_out, n_out, w, ws + t.big[L], ws + t.small[L]);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The products of a chains_layer_kernel launch, kStJobs a launch over
// `rows` rows, each launch's tiles over its widest product: one persistent
// block an SM (at most one a tile). Each product's input gets its tensor
// map here (its row stride a multiple of 16 bytes: staged_layers pads a
// first layer's x that has none).
struct Products {
  StProducts t;
  int n = 0, widest = 0, sms = 1;
  cudaStream_t s;
  cudaError_t flush() {
    if (n == 0) return cudaSuccess;
    t.gx = (widest + rl8::kStFwdPass - 1) / rl8::kStFwdPass;
    t.gy = (int)((t.rows + rl8::kStRows - 1) / rl8::kStRows);
    t.n = n;
    n = widest = 0;
    const long long tiles = (long long)t.gx * t.gy * t.n;
    const long long blocks = tiles > sms ? sms : tiles;
    chains_layer_kernel<<<(unsigned)blocks, rl8::kWsThreads, rl8::kWsSmem, s>>>(t);
    return cudaGetLastError();
  }
  cudaError_t add(const StProduct& p) {
    if (!rows_map(&t.map[n], p.in, t.rows, p.K, p.ld_in)) return cudaErrorInvalidValue;
    t.p[n++] = p;
    widest = p.N > widest ? p.N : widest;
    return n == kStJobs ? flush() : cudaSuccess;
  }
};

// The staged forward's layers on `rows` rows of x, one depth at a time over
// the chains that have that layer (keep: the backward's recompute, keeping
// each LayerNorm's xhat and s).
cudaError_t staged_layers(const float* x, long long rows, const float* params, float* ws, const Layout& Lo,
                          const Staged& S, bool keep, int sms, cudaStream_t s) {
  const Chains& d = Lo.d;
  long long ld_x = d.d_in;
  if (d.d_in % 4 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0) {
    // The first layers' tensor maps need a row stride of 16-byte multiples.
    Copies pad;
    pad.s = s;
    ld_x = round4(d.d_in);
    cudaError_t err = pad.add(Copy2d{x, ws + S.xpad, rows, ld_x, d.d_in});
    if (err == cudaSuccess) err = pad.flush();
    if (err != cudaSuccess) return err;
    x = ws + S.xpad;
  }
  const unsigned ln_blocks = (unsigned)((rows + kRowRows - 1) / kRowRows);
  auto fire_ln = [&](const LnLaunch& t, int n) {
    chains_ln_kernel<<<dim3(ln_blocks, n), kRowThreads, 0, s>>>(t);
    return cudaGetLastError();
  };
  cudaError_t err;
  for (int l = 0; l < S.depth; ++l) {
    Products ps;
    ps.t.rows = rows;
    ps.sms = sms;
    ps.s = s;
    Batch<LnLaunch, LnRows> ls;
    ls.t.rows = rows;
    ls.t.act = d.act;
    for (int c = 0; c < d.n_chains; ++c) {
      if (l >= d.n_layers[c]) continue;
      const StagedChain& t = S.c[c];
      const int w = d.width[c][l], in_w = l == 0 ? d.d_in : d.width[c][l - 1];
      const float* b = params + d.woff[c][l] + (long long)in_w * w;
      err = ps.add(StProduct{l == 0 ? x : ws + t.h[l - 1], ws + t.fwd[l], b, ws + t.h[l],
                             l == 0 ? ld_x : t.ld[l - 1], t.ld[l], in_w, w, d.ln[c][l] ? kIdentity : d.act});
      if (err != cudaSuccess) return err;
    }
    // Every product of the depth before its LayerNorms (chains_ln_kernel
    // reads the products' outputs).
    if ((err = ps.flush()) != cudaSuccess) return err;
    for (int c = 0; c < d.n_chains; ++c) {
      if (l >= d.n_layers[c] || !d.ln[c][l]) continue;
      const StagedChain& t = S.c[c];
      const int w = d.width[c][l], in_w = l == 0 ? d.d_in : d.width[c][l - 1];
      const float* b = params + d.woff[c][l] + (long long)in_w * w;
      err = ls.add(LnRows{ws + t.h[l], b + w, b + 2 * w, keep ? ws + t.xhat[l] : nullptr,
                          keep ? ws + t.s[l] : nullptr, t.ld[l], w},
                   fire_ln);
      if (err != cudaSuccess) return err;
    }
    if ((err = ls.flush(fire_ln)) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The staged forward (see the file's head) on `ws` (make_staged(Lo,
// false)'s floats); saving, on the saved layout (make_staged(Lo, true, ..,
// true)'s floats, every row in one chunk): the backward's weight copies
// too, and every h_l and each LayerNorm's xhat_l and s_l kept, which the
// saved backward reads.
cudaError_t staged_forward(const float* x, const float* params, float* ws, const Layout& Lo, bool saving,
                           cudaStream_t s) {
  const Chains& d = Lo.d;
  Staged S;
  if (!saving) {
    make_staged(Lo, false, &S);
  } else if (!make_staged(Lo, true, &S, true) || S.chunk != d.N) {
    return cudaErrorInvalidValue;
  }
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = staged_attributes(device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  if ((err = staged_copies(params, ws, Lo, S, s)) != cudaSuccess) return err;
  if ((err = staged_layers(x, d.N, params, ws, Lo, S, saving, sms, s)) != cudaSuccess) return err;
  Products wide;
  wide.t.rows = d.N;
  wide.sms = sms;
  wide.s = s;
  Batch<HeadLaunch, HeadRows> hl;
  hl.t.rows = d.N;
  auto fire_heads = [&](const HeadLaunch& t, int n) {
    chains_heads_kernel<<<dim3((unsigned)((d.N + kHeadRows - 1) / kHeadRows), n), rl8::kStThreads, 0, s>>>(t);
    return cudaGetLastError();
  };
  for (int c = 0; c < d.n_chains; ++c) {
    const StagedChain& t = S.c[c];
    const int L = d.n_layers[c], w = d.width[c][L - 1];
    for (int j = 0; j < d.n_heads[c]; ++j) {
      const int hw = d.head_w[c][j];
      const float* W = params + d.woff[c][L + j];
      if (hw >= kNarrow) {
        err = wide.add(StProduct{ws + t.h[L - 1], ws + t.head[j], W + (long long)w * hw, d.out[c][j], t.ld[L - 1],
                                 hw, w, hw, kIdentity});
      } else {
        err = hl.add(HeadRows{ws + t.h[L - 1], W, d.out[c][j], t.ld[L - 1], w, hw}, fire_heads);
      }
      if (err != cudaSuccess) return err;
    }
  }
  if ((err = wide.flush()) != cudaSuccess) return err;
  return hl.flush(fire_heads);
}

// The staged backward (see the file's head) on `ws` (make_staged(Lo,
// true)'s floats), over chunks of S.chunk rows in order: each chunk's
// recompute, dh products and dx, then its weight products, whose partials
// are summed into grads (the first chunk's written, the others added).
// saved: ws is the saving forward's (the saved layout, one chunk of every
// row), whose weight copies and activations it reads in place of the
// copies and the recompute.
cudaError_t staged_backward(const float* x, const float* params, float* dx, float* grads, float* ws, const Layout& Lo,
                            bool saved, cudaStream_t s) {
  const Chains& d = Lo.d;
  const long long N = d.N;
  Staged S;
  if (!make_staged(Lo, true, &S, saved) || (saved && S.chunk != N)) return cudaErrorInvalidValue;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = staged_attributes(device);
  if (err == cudaSuccess) err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  if (!saved && (err = staged_copies(params, ws, Lo, S, s)) != cudaSuccess) return err;
  const long long R = S.chunk;
  float* dxc = ws + S.dxc;
  float* partials = ws + S.partials;
  std::vector<Job> jobs;
  for (long long c0 = 0; c0 < N; c0 += R) {
    const long long n = N - c0 < R ? N - c0 : R;
    const float* xc = x + c0 * d.d_in;
    if (!saved && (err = staged_layers(xc, n, params, ws, Lo, S, true, sms, s)) != cudaSuccess) return err;
    // Each chain's head cotangents side by side.
    Copies douts;
    douts.s = s;
    for (int c = 0; c < d.n_chains; ++c) {
      for (int j = 0; j < d.n_heads[c]; ++j) {
        const int hw = d.head_w[c][j];
        err = douts.add(Copy2d{d.dout[c][j] + c0 * hw, ws + S.c[c].dout + (d.head_col[c][j] - d.head_col[c][0]), n,
                               S.c[c].ld_out, hw});
        if (err != cudaSuccess) return err;
      }
    }
    if ((err = douts.flush()) != cudaSuccess) return err;
    // Down the chains from the top, one step a launch (kStJobs chains
    // each): step i takes chain c from layer L_c - i to layer l = L_c - 1 -
    // i (at i = 0, from the heads).
    const unsigned dh_blocks = rl8::st_row_grid(n);
    auto fire_dh = [&](const DhLaunch& t, int m) {
      chains_dh_kernel<<<dim3(dh_blocks, m), rl8::kStThreads, rl8::kStBwdSmem, s>>>(t);
      return cudaGetLastError();
    };
    auto fire_ln = [&](const LnBwdLaunch& t, int m) {
      chains_ln_bwd_kernel<<<dim3((unsigned)((n + kRowRows - 1) / kRowRows), m), kRowThreads, 0, s>>>(t);
      return cudaGetLastError();
    };
    for (int i = 0; i < S.depth; ++i) {
      Batch<DhLaunch, DhProduct> dh;
      dh.t.rows = n;
      dh.t.act = d.act;
      Batch<LnBwdLaunch, LnBwdRows> lb;
      lb.t.rows = n;
      for (int c = 0; c < d.n_chains; ++c) {
        const int L = d.n_layers[c], l = L - 1 - i;
        if (l < 0) continue;
        const StagedChain& t = S.c[c];
        const int w = d.width[c][l], above = i == 0 ? L : l + 1;
        const bool ln = d.ln[c][l];
        err = dh.add(DhProduct{i == 0 ? ws + t.dout : ws + t.dpre[l + 1], ws + t.big[above], ws + t.small[above],
                               ws + t.h[l], ws + (ln ? t.da[l] : t.dpre[l]), i == 0 ? t.ld_out : t.ld[l + 1], t.ld[l],
                               t.ld[l], i == 0 ? d.chain_out[c] : d.width[c][l + 1], w},
                     fire_dh);
        if (err != cudaSuccess) return err;
      }
      // Every dh product of the step before its LayerNorms.
      if ((err = dh.flush(fire_dh)) != cudaSuccess) return err;
      for (int c = 0; c < d.n_chains; ++c) {
        const int L = d.n_layers[c], l = L - 1 - i;
        if (l < 0 || !d.ln[c][l]) continue;
        const StagedChain& t = S.c[c];
        const int w = d.width[c][l], in_w = l == 0 ? d.d_in : d.width[c][l - 1];
        const float* scale = params + d.woff[c][l] + (long long)in_w * w + w;
        err = lb.add(LnBwdRows{ws + t.da[l], ws + t.xhat[l], ws + t.s[l], scale, ws + t.dpre[l], t.ld[l], w},
                     fire_ln);
        if (err != cudaSuccess) return err;
      }
      if ((err = lb.flush(fire_ln)) != cudaSuccess) return err;
    }
    // Each chain's dx = dpre_0 W_0^T (chain c's at dxc + c R d_in), then
    // their sum in chain order into the chunk's rows of dx.
    if (d.d_in >= kNarrow) {
      Batch<DhLaunch, DhProduct> dh;
      dh.t.rows = n;
      dh.t.act = d.act;
      for (int c = 0; c < d.n_chains; ++c) {
        const StagedChain& t = S.c[c];
        err = dh.add(DhProduct{ws + t.dpre[0], ws + t.big[0], ws + t.small[0], nullptr, dxc + (long long)c * R * d.d_in,
                               t.ld[0], 0, d.d_in, d.width[c][0], d.d_in},
                     fire_dh);
        if (err != cudaSuccess) return err;
      }
      if ((err = dh.flush(fire_dh)) != cudaSuccess) return err;
    } else {
      Batch<DxLaunch, DxRows> xl;
      xl.t.rows = n;
      xl.t.d_in = d.d_in;
      auto fire_dx = [&](const DxLaunch& t, int m) {
        chains_dx_kernel<<<dim3((unsigned)((n + kHeadRows - 1) / kHeadRows), m), rl8::kStThreads, 0, s>>>(t);
        return cudaGetLastError();
      };
      for (int c = 0; c < d.n_chains; ++c) {
        err = xl.add(DxRows{ws + S.c[c].dpre[0], params + d.woff[c][0], dxc + (long long)c * R * d.d_in,
                            S.c[c].ld[0], d.width[c][0]},
                     fire_dx);
        if (err != cudaSuccess) return err;
      }
      if ((err = xl.flush(fire_dx)) != cudaSuccess) return err;
    }
    sum_chain_dx_kernel<<<rl8::grid_for(n * d.d_in), rl8::kWgThreads, 0, s>>>(dxc, d.n_chains, R * d.d_in,
                                                                              n * d.d_in, dx + c0 * d.d_in);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    // The weight products: dW = h_in^T dpre and db per layer (and a
    // LayerNorm's dscale = sum(da xhat), dbias = sum(da) as bias-only column
    // sums), and per head h_last^T dout.
    jobs.clear();
    for (int c = 0; c < d.n_chains; ++c) {
      const StagedChain& t = S.c[c];
      const int L = d.n_layers[c];
      int in = d.d_in;
      for (int l = 0; l < L; ++l) {
        const int w = d.width[c][l];
        const float* a = l == 0 ? xc : ws + t.h[l - 1];
        const long long lda = l == 0 ? d.d_in : t.ld[l - 1];
        jobs.push_back(rl8::make_job(a, lda, ws + t.dpre[l], t.ld[l], in, w, d.woff[c][l]));
        if (d.ln[c][l]) {
          const long long scale_off = d.woff[c][l] + (long long)in * w + w;
          jobs.push_back(rl8::make_job(a, lda, ws + t.xhat[l], t.ld[l], 0, w, scale_off));
          jobs.push_back(rl8::make_job(a, lda, ws + t.da[l], t.ld[l], 0, w, scale_off + w));
        }
        in = w;
      }
      for (int j = 0; j < d.n_heads[c]; ++j) {
        const int hw = d.head_w[c][j];
        jobs.push_back(rl8::make_job(ws + t.h[L - 1], t.ld[L - 1], d.dout[c][j] + c0 * hw, hw, in, hw,
                                     d.woff[c][L + j]));
      }
    }
    long long g = (n + kGroupRows - 1) / kGroupRows;
    g = g > S.groups ? S.groups : g;
    const long long rows_per_group = (n + g - 1) / g;
    err = rl8::launch_jobs(jobs.data(), (long long)jobs.size(), n, (int)g, rows_per_group, Lo.P, partials, s);
    if (err != cudaSuccess) return err;
    rl8::sum_partials_kernel<<<rl8::grid_for(Lo.P), rl8::kWgThreads, 0, s>>>(partials, (int)g, Lo.P, grads, c0 > 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// Floats of workspace that rl8_chains_fwd (backward = 0) or rl8_chains_bwd
// (backward = 1) needs, or -1 where the spec is malformed (or, backward,
// the staged route's weight copies and partials leave no room in its
// budget for one row block): 0 where the forward takes its tiled route; the
// tiled backward's partials (at most kMaxTileBlocks / its launches' chains
// groups) and per-chain dx; else the staged route's copies, row scratch and
// (backward) partials (make_staged). backward = 2: the saved layout's
// floats, which a saving rl8_chains_fwd fills and a saved rl8_chains_bwd
// reads, where the backward takes its staged route with every row in one
// chunk (rl8_chains_chunk_rows answers N) and the forward its staged route;
// else 0 (the backward recomputes).
extern "C" long long rl8_chains_workspace(long long N, int d_in, const int* spec, int spec_len, int backward) {
  Layout L = {};
  if (!make_layout(N, d_in, kRelu, spec, spec_len, &L)) return -1;
  Staged S;
  if (backward == 2) {
    Tiled T;
    std::vector<TileChain> tc;
    FwdTiled F;
    std::vector<FwdChain> fc;
    if (make_tiled(L, &T, &tc) || make_fwd_tiled(L, &F, &fc)) return 0;
    if (!make_staged(L, true, &S, true)) return -1;
    return S.chunk == N ? S.floats : 0;
  }
  if (!backward) {
    FwdTiled F;
    std::vector<FwdChain> fc;
    if (make_fwd_tiled(L, &F, &fc)) return 0;
    make_staged(L, false, &S);
    return S.floats;
  }
  Tiled T;
  std::vector<TileChain> tc;
  if (make_tiled(L, &T, &tc)) return (long long)T.groups * L.P + (long long)L.d.n_chains * N * d_in;
  return make_staged(L, true, &S) ? S.floats : -1;
}

// Floats of the weight products' partials that rl8_chains_bwd writes on
// these chains: the staged route's groups times the parameter count
// (make_staged), or at most the tiled route's (its workspace's groups; a
// launch takes fewer where the card holds fewer blocks at once); -1 where
// rl8_chains_workspace answers -1.
extern "C" long long rl8_chains_partials(long long N, int d_in, const int* spec, int spec_len) {
  Layout L = {};
  if (!make_layout(N, d_in, kRelu, spec, spec_len, &L)) return -1;
  Tiled T;
  std::vector<TileChain> tc;
  if (make_tiled(L, &T, &tc)) return (long long)T.groups * L.P;
  Staged S;
  return make_staged(L, true, &S) ? (long long)S.groups * L.P : -1;
}

// Rows of a chunk of rl8_chains_bwd's staged route (N where every row fits
// its budget at once; 0 where the backward takes its tiled route), or -1
// where rl8_chains_workspace answers -1.
extern "C" long long rl8_chains_chunk_rows(long long N, int d_in, const int* spec, int spec_len) {
  Layout L = {};
  if (!make_layout(N, d_in, kRelu, spec, spec_len, &L)) return -1;
  Tiled T;
  std::vector<TileChain> tc;
  if (make_tiled(L, &T, &tc)) return 0;
  Staged S;
  return make_staged(L, true, &S) ? S.chunk : -1;
}

// outs: a host array of each head's output [N, hw], chain by chain;
// workspace holds rl8_chains_workspace(..., 0) floats (null where that is
// 0). save: the saving forward, on rl8_chains_workspace(..., 2) floats
// (invalid where that is not positive: the same staged route and bits as
// without save).
extern "C" int rl8_chains_fwd(const float* x, const float* params, float* const* outs, float* workspace, long long N,
                              int d_in, const int* spec, int spec_len, int act, int save, int device, void* stream) {
  Layout L = {};
  if (!make_layout(N, d_in, act, spec, spec_len, &L)) return (int)cudaErrorInvalidValue;
  for (int c = 0, q = 0; c < L.d.n_chains; ++c) {
    for (int j = 0; j < L.d.n_heads[c]; ++j) L.d.out[c][j] = outs[q++];
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  FwdTiled F;
  std::vector<FwdChain> fc;
  if (save) {
    Tiled T;
    std::vector<TileChain> tc;
    if (workspace == nullptr || make_tiled(L, &T, &tc) || make_fwd_tiled(L, &F, &fc)) {
      return (int)cudaErrorInvalidValue;
    }
    return (int)staged_forward(x, params, workspace, L, true, (cudaStream_t)stream);
  }
  if (make_fwd_tiled(L, &F, &fc)) {
    // The tiled route: as many persistent blocks as the card holds at once
    // (within the row tiles), split evenly over a launch's chains; a launch
    // for every kTileChains chains.
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    // The activation is a template argument: chosen at run time, every
    // activation also paid for tanhf's instructions.
    auto kernel = act == kRelu ? chains_fwd_tiles_kernel<kRelu> : chains_fwd_tiles_kernel<kTanh>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kFwdTileThreads, F.smem);
    if (err != cudaSuccess) return (int)err;
    const int tiles = F.groups;
    for (int base = 0; base < L.d.n_chains; base += kTileChains) {
      F.n_chains = L.d.n_chains - base < kTileChains ? L.d.n_chains - base : kTileChains;
      for (int i = 0; i < F.n_chains; ++i) F.c[i] = fc[base + i];
      const int fit = sms * per_sm / F.n_chains;
      F.groups = fit < 1 ? 1 : (fit < tiles ? fit : tiles);
      kernel<<<dim3(F.groups, F.n_chains), kFwdTileThreads, F.smem, (cudaStream_t)stream>>>(x, params, F);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    return (int)cudaSuccess;
  }
  if (workspace == nullptr) return (int)cudaErrorInvalidValue;
  return (int)staged_forward(x, params, workspace, L, false, (cudaStream_t)stream);
}

// douts: a host array of each head's cotangent [N, hw], chain by chain; dx
// [N, d_in] and grads [P] (the flat parameter layout) are outputs; workspace
// holds rl8_chains_workspace(..., 1) floats, or (saved) the workspace of a
// saving rl8_chains_fwd on the same x and params, whose activations and
// weight copies it reads (and overwrites: one saved backward a forward).
extern "C" int rl8_chains_bwd(const float* x, const float* params, const float* const* douts, float* dx,
                              float* grads, float* workspace, long long N, int d_in, const int* spec, int spec_len,
                              int act, int saved, int device, void* stream) {
  Layout L = {};
  if (!make_layout(N, d_in, act, spec, spec_len, &L)) return (int)cudaErrorInvalidValue;
  for (int c = 0, q = 0; c < L.d.n_chains; ++c) {
    for (int j = 0; j < L.d.n_heads[c]; ++j) L.d.dout[c][j] = douts[q++];
  }
  const Chains& d = L.d;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;

  Tiled T;
  std::vector<TileChain> tc;
  const bool tiled = make_tiled(L, &T, &tc);
  if (saved && tiled) return (int)cudaErrorInvalidValue;
  if (tiled) {
    // The tiled route: as many persistent blocks as the card holds at once
    // (within the workspace's groups), split evenly over a launch's chains;
    // a launch for every kTileChains chains, each writing its chains'
    // columns of the same partial rows.
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(chains_bwd_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T.smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, chains_bwd_tiles_kernel, kTileThreads, T.smem);
    if (err != cudaSuccess) return (int)err;
    const int fit = sms * per_sm / T.n_chains;
    T.groups = fit < 1 ? 1 : (fit < T.groups ? fit : T.groups);
    float* partials = workspace;
    float* dxc = partials + (long long)T.groups * L.P;
    for (int base = 0; base < d.n_chains; base += kTileChains) {
      T.base = base;
      T.n_chains = d.n_chains - base < kTileChains ? d.n_chains - base : kTileChains;
      for (int i = 0; i < T.n_chains; ++i) T.c[i] = tc[base + i];
      chains_bwd_tiles_kernel<<<dim3(T.groups, T.n_chains), kTileThreads, T.smem, s>>>(x, params, partials, dxc, T);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    rl8::sum_partials_kernel<<<rl8::grid_for(L.P), rl8::kWgThreads, 0, s>>>(partials, T.groups, L.P, grads, 0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    sum_chain_dx_kernel<<<rl8::grid_for(N * d_in), rl8::kWgThreads, 0, s>>>(dxc, d.n_chains, N * d_in, N * d_in, dx);
    return (int)cudaGetLastError();
  }
  return (int)staged_backward(x, params, dx, grads, workspace, L, saved != 0, s);
}
