// Interior-stencil apply of the grid-layout cut-FEM operator, for Hopper.
//
// Replaces the Pallas TPU kernel cutfemx_tpu/pallas_stencil.py::_kernel.
// Every lattice cube q with cube_mask[q] != 0 reads its L slot values
// X[ch(s), q + off(s)] (offsets in {0,1}^3), multiplies them by the
// constant L x L cube matrix A and adds the result to the same slots:
//
//   Y[c', p] = sum over slots sp with ch(sp) = c' and cube q = p - off(sp)
//              in [0, n)^3 with mask[q]:  sum_s A[sp, s] * X[ch(s), q + off(s)]
//
// (y = A x per cube: rows are the test functions, as in the element path.)
//
// What bounds it on an H100: bytes. It does 2 L^2 flops per cube (1458 for
// P2) against one read and one write of the nch * N^3 grid, an arithmetic
// intensity far below the card's; at n = 48 the whole f32 grid is 3.8 MB
// and sits in the 50 MB L2.
//
// Design: one thread per output value (channel, point), assembled
// gather-style — each thread recomputes the cube rows that land on its
// point, so no two threads write one address: no atomics, and the sum
// order is fixed from run to run. A and the slot table are staged in
// shared memory at block start (at most 27^2 doubles, 5.8 KB). Neighbouring
// threads own neighbouring z points of one channel, so the grid reads of a
// warp are coalesced and the many re-reads of a value hit L1/L2. The TPU
// layout artifacts (128-lane z padding, +8 DMA slack, z offsets as lane
// rolls, the padded mask) have no counterpart here.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SLOTS 27

// slot[i] packs (channel, dx, dy, dz) as ch << 3 | dx << 2 | dy << 1 | dz.
// Passed by value, so it travels in the kernel's parameter space.
struct SlotTable {
  int n_slots;
  int slot[MAX_SLOTS];
};

template <typename T>
__global__ void interior_stencil_kernel(const T* __restrict__ X,
                                        const T* __restrict__ A,
                                        const uint8_t* __restrict__ mask,
                                        T* __restrict__ Y, int n, int N,
                                        int nch, SlotTable tab) {
  __shared__ T sA[MAX_SLOTS * MAX_SLOTS];
  __shared__ int sSlot[MAX_SLOTS];
  const int L = tab.n_slots;
  for (int t = threadIdx.x; t < L * L; t += blockDim.x) sA[t] = A[t];
  for (int t = threadIdx.x; t < L; t += blockDim.x) sSlot[t] = tab.slot[t];
  __syncthreads();

  const int64_t NNN = (int64_t)N * N * N;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= nch * NNN) return;
  const int c = (int)(idx / NNN);
  const int64_t p = idx - c * NNN;
  const int i = (int)(p / ((int64_t)N * N));
  const int j = (int)((p / N) % N);
  const int k = (int)(p % N);

  T acc = T(0);
  for (int sp = 0; sp < L; ++sp) {
    const int e = sSlot[sp];
    if ((e >> 3) != c) continue;
    const int qi = i - ((e >> 2) & 1);
    const int qj = j - ((e >> 1) & 1);
    const int qk = k - (e & 1);
    if (qi < 0 || qj < 0 || qk < 0 || qi >= n || qj >= n || qk >= n)
      continue;
    if (!mask[((int64_t)qi * n + qj) * n + qk]) continue;
    const T* Arow = sA + sp * L;
    T y = T(0);
    for (int s = 0; s < L; ++s) {
      const int f = sSlot[s];
      const int64_t src = (int64_t)(f >> 3) * NNN +
                          ((int64_t)(qi + ((f >> 2) & 1)) * N +
                           (qj + ((f >> 1) & 1))) * N +
                          (qk + (f & 1));
      y += Arow[s] * X[src];
    }
    acc += y;
  }
  Y[idx] = acc;
}

template <typename T>
static int launch(const void* X, const void* A, const void* mask, void* Y,
                  int n, int N, int nch, SlotTable tab, void* stream) {
  if (tab.n_slots < 1 || tab.n_slots > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int64_t total = (int64_t)nch * N * N * N;
  const int64_t blocks = (total + threads - 1) / threads;
  interior_stencil_kernel<T><<<(unsigned)blocks, threads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)X, (const T*)A, (const uint8_t*)mask, (T*)Y, n, N, nch, tab);
  return (int)cudaGetLastError();
}

extern "C" int interior_stencil_f32(const void* X, const void* A,
                                    const void* mask, void* Y, int n, int N,
                                    int nch, SlotTable tab, void* stream) {
  return launch<float>(X, A, mask, Y, n, N, nch, tab, stream);
}

extern "C" int interior_stencil_f64(const void* X, const void* A,
                                    const void* mask, void* Y, int n, int N,
                                    int nch, SlotTable tab, void* stream) {
  return launch<double>(X, A, mask, Y, n, N, nch, tab, stream);
}
