// Interior-stencil apply of the grid-layout cut-FEM operator, for Hopper.
//
// Replaces the Pallas TPU kernel cutfemx_tpu/pallas_stencil.py::_kernel
// (launched by _stencil_call, pallas_call at :132). Every lattice cube q
// with cube_mask[q] != 0 reads its L slot values X[ch(s), q + off(s)]
// (offsets in {0,1}^3), multiplies them by the constant L x L cube matrix A
// and adds the result to the same slots:
//
//   Y[c', p] = sum over slots sp with ch(sp) = c' and cube q = p - off(sp)
//              in [0, n)^3 with mask[q]:  sum_s A[sp, s] * X[ch(s), q + off(s)]
//
// (y = A x per cube: rows are the test functions, as in the element path.)
//
// What bounds it on an H100: bytes. The function must write the whole
// nch * N^3 output once and read the n^3 mask once; it reads X only where a
// full cube touches it, 2 L^2 flops per full cube (1458 for P2), an
// arithmetic intensity far below the card's. At the bench's mask 4% of the
// cubes are full, so most of the bytes are the output's zeros.
//
// Design: the output is cut into tiles of TX x TY x TZ points, all channels
// (TZ = 32 = the warp: z is the fast axis, so a warp reads and writes one
// contiguous z run). A persistent grid (as many blocks as fit on the card)
// deals out the pencils of tiles (the ntz tiles of one (x, y) footprint)
// round-robin, block b taking pencils b, b + gridDim.x, ...
// 1. Empty-tile exit: a block loads the cube windows (cubes p0-1 .. p0+T-1
//    per axis, zero outside [0, n)) of up to BATCH tiles of its pencil at
//    once into shared memory, the next batch's while it works on this one,
//    and one block reduction says which of the tiles hold a full cube. A
//    tile with none is written as zeros and never reads X. Warp (i, j)
//    writes the runs of its row (x0+i, y0+j) one after the other, so the
//    zeros leave as contiguous rows, as a plain fill writes them. No
//    host-side tile list is needed.
// 2. An occupied tile stages its point window (points p0-1 .. p0+T per
//    axis, all channels) with cp.async, only the points a full cube of the
//    window touches: X is read from device memory where the bound counts
//    it (halo points shared by two tiles twice, the second time mostly from
//    L2). Two window buffers: the next occupied tile's window loads while
//    this one computes. A is staged once per block.
// 3. The output is assembled gather-style from shared memory, one warp per
//    (x, y) run and one thread per point, all channels in registers. For
//    each of the 8 cubes q = p - o around the point (o in {0,1}^3, in
//    increasing order), a thread whose cube is full loads the cube's L
//    values once into registers and adds, for every slot sp with
//    off(sp) = o, the row A[sp, :] . X(q) (s = 0 .. L-1) to its channel.
//    So each channel sums its slots in increasing offset order, which is
//    table order for the tables the operator builds (and the plain
//    version's order). Every (cube, row) pair is computed once, every output
//    value is written by one thread (no atomics), and two launches agree
//    bitwise. All lanes read the same A value at once, a shared-memory
//    broadcast. For the operator's P2 and P1 tables the slots are
//    compile-time constants, so every A offset and window offset is an
//    immediate; any other table takes the same path with the slots read
//    from shared memory.
// Boxes: the grid need not be a cube of cubes. A launch takes nb boxes one
// after the other in memory, each nx x ny x nz cubes (its mask) on
// Nx x Ny x Nz points (its channels' grids), N_a >= n_a + 1 per axis; the
// cube q of a box touches its points q .. q + 1. The operator's grid is one
// box with n_a = n, N_a = n + 1; a slab of the distributed solve is
// Wmax x n x n cubes on (Wmax + 2) x N x N points, and the slabs stacked on
// one card go as nb boxes in one launch. Pencils are dealt out over all
// boxes; points no full cube touches (a box's planes past n_a) are zeros.
// Index arithmetic is 32-bit inside the tile; only the tile's base offsets
// into the grid, the channel and the box strides are 64-bit. The TPU layout artifacts
// (128-lane z padding, +8 DMA slack, z offsets as lane rolls, the padded
// mask) have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SLOTS 27
#define MAX_CH 8

// slot[i] packs (channel, dx, dy, dz) as ch << 3 | dx << 2 | dy << 1 | dz.
// Passed by value, so it travels in the kernel's parameter space.
struct SlotTable {
  int n_slots;
  int slot[MAX_SLOTS];
};

// nb boxes of nx x ny x nz cubes on Nx x Ny x Nz points (see above)
struct Box {
  int nb, nx, ny, nz, Nx, Ny, Nz;
};

// The output tile, in points per axis: the one place to tune it. TZ = 32
// is the warp, and TX * TY runs give each warp of the block one run.
constexpr int TX = 2, TY = 4, TZ = 32;
constexpr int WARPS = TX * TY;
constexpr int THREADS = 32 * WARPS;
constexpr int BLOCKS_PER_SM = 2;   // launch bound: <= 128 registers a thread
constexpr int BATCH = 4;           // tiles of a pencil classified at once
static_assert(TZ == 32, "a warp owns one z run of the tile");

// the point window p0-1 .. p0+T per axis, z fastest
constexpr int WX = TX + 2, WY = TY + 2, WZ = TZ + 2;
constexpr int SY = WZ, SX = WY * WZ, WIN = WX * WY * WZ;
// the cube window p0-1 .. p0+T-1 per axis, z fastest
constexpr int CSY = TZ + 1, CSX = (TY + 1) * CSY, MW = (TX + 1) * CSX;
constexpr int MR = (MW + THREADS - 1) / THREADS;   // window cubes a thread

__host__ __device__ constexpr int round4(int v) { return (v + 3) & ~3; }

// window offsets of the point, or cube, at offset o = dx << 2 | dy << 1 | dz
__host__ __device__ constexpr int shift(int o) {
  return ((o >> 2) & 1) * SX + ((o >> 1) & 1) * SY + (o & 1);
}
__host__ __device__ constexpr int cshift(int o) {
  return ((o >> 2) & 1) * CSX + ((o >> 1) & 1) * CSY + (o & 1);
}

// The slot tables the operator builds (stencil._local_dof_table), packed
// as above. ID 2, Lagrange P2: 8 vertex, 12 edge, 6 face and 1 cell slots
// on 8 channels, 6 bits a slot, 10 slots a word:
//   0..7, 8, 9, 10, 11, 16, 17, 20, 21, 24, 26, 28, 30, 32, 33, 40, 42,
//   48, 52, 56.
// ID 1, Lagrange P1: the 8 vertices on one channel, slot k = k. ID 0: a
// table known only at run time.
template <int ID> struct Table {
  static constexpr int L = 0;
};
template <> struct Table<2> {
  static constexpr int L = 27;
  __host__ __device__ static constexpr int slot(int k) {
    return (int)(((k < 10   ? 0x2481c61440c2040ull
                   : k < 20 ? 0x79c6985544502caull
                            : 0x38d30aa8860ull) >>
                  (6 * (k % 10))) &
                 63);
  }
};
template <> struct Table<1> {
  static constexpr int L = 8;
  __host__ __device__ static constexpr int slot(int k) { return k; }
};

template <int ID>
static bool table_is(const SlotTable& tab) {
  if (tab.n_slots != Table<ID>::L) return false;
  for (int k = 0; k < Table<ID>::L; ++k)
    if (tab.slot[k] != Table<ID>::slot(k)) return false;
  return true;
}

// Shared memory of one block, in this order: A (L x L, row-major), two X
// windows (nch * WIN values each, rounded to 4), per slot in (offset, table) order its row in A and its channel,
// each offset's first slot in that order, the warps' occupied flags, and
// BATCH cube windows (MW bytes each).
template <typename T>
__host__ __device__ inline int smem_bytes(int nch, int L) {
  return (round4(L * L) + 2 * round4(nch * WIN)) * (int)sizeof(T) +
         (2 * MAX_SLOTS + 9 + WARPS) * (int)sizeof(int) + BATCH * MW;
}

template <int B>
__device__ __forceinline__ void cp_async(void* smem_dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(smem_dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
               "l"(src), "n"(B));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// this thread's share of the cube window of the tile at (x0, y0, z0):
// window cube e = tid + r * THREADS is cube (x0-1+a, y0-1+b, z0-1+c);
// 0 outside the grid and past the window
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ mask,
                                            const Box& bx, int x0, int y0,
                                            int z0, int tid, uint8_t (&m)[MR]) {
  const int64_t base =
      ((int64_t)(x0 - 1) * bx.ny + (y0 - 1)) * bx.nz + (z0 - 1);
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    const int e = tid + r * THREADS;
    const int a = e / CSX, b = (e / CSY) % (TY + 1), c = e % CSY;
    const int qx = x0 - 1 + a, qy = y0 - 1 + b, qz = z0 - 1 + c;
    m[r] = (e < MW && qx >= 0 && qy >= 0 && qz >= 0 && qx < bx.nx &&
            qy < bx.ny && qz < bx.nz)
               ? mask[base + (a * bx.ny + b) * bx.nz + c]
               : 0;
  }
}

// Stage the X window of the tile at (x0, y0, z0) into sX: the points a
// full cube of its cube window sM touches (all inside the grid), by
// cp.async; the others are never read.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ X, T* sX,
                                             const uint8_t* sM, int x0,
                                             int y0, int z0, const Box& bx,
                                             int nch, int tid) {
  const int64_t NNN = (int64_t)bx.Nx * bx.Ny * bx.Nz;
  const int64_t xbase =
      ((int64_t)(x0 - 1) * bx.Ny + (y0 - 1)) * bx.Nz + (z0 - 1);
  for (int w = tid; w < WIN; w += THREADS) {
    const int a = w / SX, b = (w / SY) % WY, c = w % SY;
    uint8_t h = 0;
#pragma unroll
    for (int da = 0; da <= 1; ++da)
#pragma unroll
      for (int db = 0; db <= 1; ++db)
#pragma unroll
        for (int dc = 0; dc <= 1; ++dc) {
          const int ca = a - da, cb = b - db, cc = c - dc;
          if (ca >= 0 && ca <= TX && cb >= 0 && cb <= TY && cc >= 0 &&
              cc <= TZ)
            h |= sM[ca * CSX + cb * CSY + cc];
        }
    if (h) {
      const T* src = X + xbase + (a * bx.Ny + b) * bx.Nz + c;
      for (int ch = 0; ch < nch; ++ch)
        cp_async<(int)sizeof(T)>(sX + ch * WIN + w, src + ch * NNN);
    }
  }
}

// The thread's point p of an occupied tile: A, the point window sX and the
// cube window sM are staged. ID > 0: the compile-time table Table<ID>;
// ID = 0: the runtime table, its slots sorted by (offset, index) in sRow
// (row offset in A) / sCh / sStart and their window offsets in xo.
template <typename T, int ID>
__device__ __forceinline__ void assemble_point(
    const T* sA, const T* sX, const uint8_t* sM, const int* sRow,
    const int* sCh, const int* sStart, const int* xo, int L, int base,
    int cbase, T (&acc)[MAX_CH]) {
  if constexpr (ID > 0) {
    using TB = Table<ID>;
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      bool used = false;
#pragma unroll
      for (int k = 0; k < TB::L; ++k) used |= (TB::slot(k) & 7) == o;
      if (!used || !sM[cbase - cshift(o)]) continue;
      const int q = base - shift(o);   // cube p - o
      T x[TB::L];
#pragma unroll
      for (int s = 0; s < TB::L; ++s)
        x[s] = sX[q + (TB::slot(s) >> 3) * WIN + shift(TB::slot(s) & 7)];
#pragma unroll
      for (int k = 0; k < TB::L; ++k) {
        if ((TB::slot(k) & 7) != o) continue;
        T y = T(0);
#pragma unroll
        for (int s = 0; s < TB::L; ++s) y += sA[k * TB::L + s] * x[s];
        acc[TB::slot(k) >> 3] += y;
      }
    }
  } else {
#pragma unroll
    for (int o = 0; o < 8; ++o) {
      const int k1 = sStart[o + 1];
      int k = sStart[o];
      if (k == k1 || !sM[cbase - cshift(o)]) continue;
      const int q = base - shift(o);
      T x[MAX_SLOTS];
#pragma unroll
      for (int s = 0; s < MAX_SLOTS; ++s)
        x[s] = s < L ? sX[q + xo[s]] : T(0);
      for (; k < k1; ++k) {
        const int row = sRow[k];
        T y = T(0);
#pragma unroll
        for (int s = 0; s < MAX_SLOTS; ++s)
          if (s < L) y += sA[row + s] * x[s];
        const int ck = sCh[k];
#pragma unroll
        for (int c = 0; c < MAX_CH; ++c)
          if (c == ck) acc[c] += y;
      }
    }
  }
}

template <typename T, int ID>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
interior_stencil_kernel(const T* __restrict__ X, const T* __restrict__ A,
                        const uint8_t* __restrict__ mask,
                        T* __restrict__ Y, Box bx, int nch,
                        SlotTable tab) {
  const int L = ID > 0 ? Table<ID>::L : tab.n_slots;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t NNN = (int64_t)bx.Nx * bx.Ny * bx.Nz;
  const int64_t MB = (int64_t)bx.nx * bx.ny * bx.nz;   // mask of a box
  const int G = gridDim.x;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem);
  T* sX = sA + round4(L * L);
  int* sRow = reinterpret_cast<int*>(sX + 2 * round4(nch * WIN));
  int* sCh = sRow + MAX_SLOTS;      // A row and channel of the k-th slot
  int* sStart = sCh + MAX_SLOTS;    // first slot of offset o, o = 0 .. 8
  int* sFlag = sStart + 9;          // per warp: the batch's occupied tiles
  uint8_t* sMb = reinterpret_cast<uint8_t*>(sFlag + WARPS);

  // the pencils of every box, and the batches of up to BATCH tiles along
  // each; pencil p is box p / ppb, footprint p % ppb
  const int ntz = (bx.Nz + TZ - 1) / TZ, nty = (bx.Ny + TY - 1) / TY;
  const int ppb = ((bx.Nx + TX - 1) / TX) * nty;
  const int pencils = bx.nb * ppb;
  int p = blockIdx.x, zb = 0;   // the pencil and first tile of the batch
  uint8_t m[BATCH][MR], mn[BATCH][MR];
#pragma unroll
  for (int k = 0; k < BATCH; ++k)
    if (p < pencils && k < ntz)
      load_window(mask + (p / ppb) * MB, bx, ((p % ppb) / nty) * TX,
                  (p % nty) * TY, k * TZ, tid, m[k]);

  // once per block: A (cp.async, waited for before the first batch) and,
  // for a runtime table, the slots sorted by (offset, table index). The
  // table is read through constant indices only, so it stays in parameter
  // space.
  for (int t = tid; t < L * L; t += THREADS)
    cp_async<(int)sizeof(T)>(sA + t, A + t);
  int xo[ID > 0 ? 1 : MAX_SLOTS];   // window offset of slot s from its cube
  if constexpr (ID == 0) {
    if (tid < L) {
      int e = 0;
#pragma unroll
      for (int k = 0; k < MAX_SLOTS; ++k)
        if (k == tid) e = tab.slot[k];
      int rank = 0;
#pragma unroll
      for (int k = 0; k < MAX_SLOTS; ++k) {
        const int ok = tab.slot[k] & 7;
        if (k < L && (ok < (e & 7) || (ok == (e & 7) && k < tid))) ++rank;
      }
      sRow[rank] = tid * L;
      sCh[rank] = e >> 3;
    }
    if (tid <= 8) {
      int start = 0;
#pragma unroll
      for (int k = 0; k < MAX_SLOTS; ++k)
        if (k < L && (tab.slot[k] & 7) < tid) ++start;
      sStart[tid] = start;
    }
#pragma unroll
    for (int s = 0; s < MAX_SLOTS; ++s)
      xo[s] = s < L ? (tab.slot[s] >> 3) * WIN + shift(tab.slot[s] & 7) : 0;
  }

  cp_async_wait_all();
  __syncthreads();

  const int i = warp / TY, j = warp % TY;   // the warp's run of a tile
  while (p < pencils) {
    const int x0 = ((p % ppb) / nty) * TX, y0 = (p % nty) * TY;
    const T* Xb = X + (int64_t)(p / ppb) * nch * NNN;
    // the next batch: this pencil's next tiles, or the next pencil's first
    const int pn = zb + BATCH < ntz ? p : p + G;
    const int zn = zb + BATCH < ntz ? zb + BATCH : 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
      if (pn < pencils && zn + k < ntz)
        load_window(mask + (pn / ppb) * MB, bx, ((pn % ppb) / nty) * TX,
                    (pn % nty) * TY, (zn + k) * TZ, tid, mn[k]);

    // which tiles of the batch hold a full cube
    unsigned occ = 0;
#pragma unroll
    for (int k = 0; k < BATCH; ++k) {
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int e = tid + r * THREADS;
        if (zb + k < ntz && e < MW) {
          sMb[k * MW + e] = m[k][r];
          if (m[k][r]) occ |= 1u << k;
        }
      }
    }
    occ = __reduce_or_sync(0xffffffffu, occ);
    if (lane == 0) sFlag[warp] = occ;
    __syncthreads();
    occ = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) occ |= sFlag[w];

    // the warp's row (x0+i, y0+j): zeros for the runs of empty tiles
    const bool row_ok = x0 + i < bx.Nx && y0 + j < bx.Ny;
    T* yrow = Y + (int64_t)(p / ppb) * nch * NNN +
              ((int64_t)(x0 + i) * bx.Ny + (y0 + j)) * bx.Nz;
    if (row_ok) {
#pragma unroll
      for (int k = 0; k < BATCH; ++k) {
        const int z = (zb + k) * TZ + lane;
        if (zb + k < ntz && !((occ >> k) & 1) && z < bx.Nz)
          for (int c = 0; c < nch; ++c) yrow[c * NNN + z] = T(0);
      }
    }

    // the occupied tiles: tile u + 1's X window loads while tile u computes
    int todo = occ;
    if (todo) stage_window(Xb, sX, sMb + (__ffs(todo) - 1) * MW, x0, y0,
                           (zb + __ffs(todo) - 1) * TZ, bx, nch, tid);
    for (int u = 0; todo; todo &= todo - 1, ++u) {
      const int k = __ffs(todo) - 1, z0 = (zb + k) * TZ;
      const uint8_t* sM = sMb + k * MW;
      const T* sXu = sX + (u & 1) * round4(nch * WIN);
      cp_async_wait_all();
      __syncthreads();   // tile u's window is in; tile u - 1 is done
      const int next = todo & (todo - 1);
      if (next)
        stage_window(Xb, sX + ((u + 1) & 1) * round4(nch * WIN),
                     sMb + (__ffs(next) - 1) * MW, x0, y0,
                     (zb + __ffs(next) - 1) * TZ, bx, nch, tid);
      if (row_ok) {
        T acc[MAX_CH];
#pragma unroll
        for (int c = 0; c < MAX_CH; ++c) acc[c] = T(0);
        assemble_point<T, ID>(sA, sXu, sM, sRow, sCh, sStart, xo, L,
                              (i + 1) * SX + (j + 1) * SY + lane + 1,
                              (i + 1) * CSX + (j + 1) * CSY + lane + 1, acc);
        if (z0 + lane < bx.Nz) {
#pragma unroll
          for (int c = 0; c < MAX_CH; ++c)
            if (c < nch) yrow[c * NNN + z0 + lane] = acc[c];
        }
      }
    }
    __syncthreads();     // the next batch overwrites the cube windows
#pragma unroll
    for (int k = 0; k < BATCH; ++k)
#pragma unroll
      for (int r = 0; r < MR; ++r) m[k][r] = mn[k][r];
    p = pn;
    zb = zn;
  }
}

template <typename T, int ID>
static int launch_tiles(const void* X, const void* A, const void* mask,
                        void* Y, Box bx, int nch, SlotTable tab,
                        void* stream) {
  const auto kernel = interior_stencil_kernel<T, ID>;
  const int bytes = smem_bytes<T>(nch, tab.n_slots);
  cudaError_t err;
  if (bytes > 48 * 1024) {   // above the default cap of dynamic smem
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int64_t pencils = (int64_t)bx.nb * ((bx.Nx + TX - 1) / TX) *
                          ((bx.Ny + TY - 1) / TY);
  const int grid = pencils < sms * per_sm ? (int)pencils : sms * per_sm;
  kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const T*)X, (const T*)A, (const uint8_t*)mask, (T*)Y, bx, nch, tab);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch(const void* X, const void* A, const void* mask, void* Y,
                  Box bx, int nch, SlotTable tab, void* stream) {
  if (tab.n_slots < 1 || tab.n_slots > MAX_SLOTS || nch < 1 ||
      nch > MAX_CH || bx.nb < 1 || bx.nx < 1 || bx.ny < 1 || bx.nz < 1 ||
      bx.Nx < bx.nx + 1 || bx.Ny < bx.ny + 1 || bx.Nz < bx.nz + 1 ||
      (int64_t)bx.Nx * bx.Ny * bx.Nz >= ((int64_t)1 << 31) ||
      (int64_t)bx.nb * ((bx.Nx + TX - 1) / TX) * ((bx.Ny + TY - 1) / TY) >=
          ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  if (nch == 8 && table_is<2>(tab))
    return launch_tiles<T, 2>(X, A, mask, Y, bx, nch, tab, stream);
  if (nch == 1 && table_is<1>(tab))
    return launch_tiles<T, 1>(X, A, mask, Y, bx, nch, tab, stream);
  return launch_tiles<T, 0>(X, A, mask, Y, bx, nch, tab, stream);
}

// The operator's cubic grid: one box of n^3 cubes on N = n + 1 points.
static Box cube(int n, int N) { return Box{1, n, n, n, N, N, N}; }

extern "C" int interior_stencil_f32(const void* X, const void* A,
                                    const void* mask, void* Y, int n, int N,
                                    int nch, SlotTable tab, void* stream) {
  if (N != n + 1) return (int)cudaErrorInvalidValue;
  return launch<float>(X, A, mask, Y, cube(n, N), nch, tab, stream);
}

extern "C" int interior_stencil_f64(const void* X, const void* A,
                                    const void* mask, void* Y, int n, int N,
                                    int nch, SlotTable tab, void* stream) {
  if (N != n + 1) return (int)cudaErrorInvalidValue;
  return launch<double>(X, A, mask, Y, cube(n, N), nch, tab, stream);
}

extern "C" int interior_stencil_box_f32(const void* X, const void* A,
                                        const void* mask, void* Y, Box bx,
                                        int nch, SlotTable tab,
                                        void* stream) {
  return launch<float>(X, A, mask, Y, bx, nch, tab, stream);
}

extern "C" int interior_stencil_box_f64(const void* X, const void* A,
                                        const void* mask, void* Y, Box bx,
                                        int nch, SlotTable tab,
                                        void* stream) {
  return launch<double>(X, A, mask, Y, bx, nch, tab, stream);
}
