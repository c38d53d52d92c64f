// Split application and candidate slot assignment from precomputed
// decision bits, the wide / categorical / EFB wave route.
//
// Replaces lightgbm_tpu/ops/histogram_pallas.py::wave_apply_pallas
// (`_wave_apply_kernel`, pallas_call at :658). Inputs: dec [Kd, N] int8
// (bit 0 = row goes left under applied entry k, bit 1 = row lands in
// candidate k's smaller child), leaf_of_row [N] int32 and the [16, 128]
// wave table (row 0 applied leaf ids, row 7 candidate leaf ids, -1 =
// inactive, row 15 nl0). Outputs: new_lor = nl0 + k for rows of applied
// entry k whose bit 0 is 0 (else unchanged), and slot = k for rows whose
// new leaf is candidate k and whose bit 1 is 1 (else -1). Entries at Kd or
// above are inactive. A leaf named by two active entries matches neither,
// as the TPU kernel's `inA == 1` / `inC == 1` rule has it.
//
// The TPU kernel compares every row against all 128 entries, because it has
// no gather. Here each block builds a leaf -> entry map in shared memory
// (the wave_table.cuh layout, LGBT_LEAF_CAP leaves) once, and each row does
// one lookup per table and reads at most two bytes of dec, only when its
// leaf is in the table.
//
// Bound: bytes. A row reads its leaf id (4 B) and at most two dec bytes and
// writes its new leaf id and slot (8 B): about 14 B per row, 14.7 MB at
// N = 2^20. Design: a grid-stride loop of one thread per row over a
// persistent grid, coalesced [N] reads and writes; the dec reads are one
// byte each, coalesced where neighbouring rows share an entry.
#include "wave_table.cuh"

#define LGBT_DUP (-2)   // leaf named by more than one active entry

// map[leaf] = k for the active entries k < Kd of table row `row`; a leaf
// named twice becomes LGBT_DUP.
__device__ __forceinline__ void lgbt_map_entries(const int* __restrict__ t,
                                                 int row, int Kd,
                                                 int leaf_cap, int* map) {
  if (threadIdx.x < LGBT_T_ENTRIES && threadIdx.x < Kd) {
    const int leaf = t[row * LGBT_T_ENTRIES + threadIdx.x];
    if (leaf >= 0 && leaf < leaf_cap) {
      const int old = atomicCAS(map + leaf, -1, (int)threadIdx.x);
      if (old != -1) atomicExch(map + leaf, LGBT_DUP);
    }
  }
}

__global__ void __launch_bounds__(LGBT_THREADS)
wave_apply_kernel(const int8_t* __restrict__ dec,
                  const int* __restrict__ lor_in,
                  const int* __restrict__ table, int* __restrict__ lor_out,
                  int* __restrict__ slot_out, long long N, int Kd,
                  int leaf_cap) {
  __shared__ int app_of[LGBT_LEAF_CAP], cand_of[LGBT_LEAF_CAP];
  for (int i = threadIdx.x; i < leaf_cap; i += blockDim.x) {
    app_of[i] = -1;
    cand_of[i] = -1;
  }
  __syncthreads();
  lgbt_map_entries(table, 0, Kd, leaf_cap, app_of);
  lgbt_map_entries(table, 7, Kd, leaf_cap, cand_of);
  __syncthreads();
  const int nl0 = table[15 * LGBT_T_ENTRIES];
  for (long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x; r < N;
       r += (long long)gridDim.x * blockDim.x) {
    int leaf = lor_in[r];
    const int ka = (unsigned)leaf < (unsigned)leaf_cap ? app_of[leaf] : -1;
    if (ka >= 0 && (dec[(long long)ka * N + r] & 1) == 0) leaf = nl0 + ka;
    lor_out[r] = leaf;
    const int kc = (unsigned)leaf < (unsigned)leaf_cap ? cand_of[leaf] : -1;
    slot_out[r] =
        (kc >= 0 && ((dec[(long long)kc * N + r] >> 1) & 1)) ? kc : -1;
  }
}

// dec [Kd, N] int8 (Kd >= 1; rows at Kd and above of the table inactive),
// lor_in / lor_out / slot_out [N] int32, table [16, 128] int32; every leaf
// id of the table and of lor_in that should match lies below leaf_cap
// (<= LGBT_LEAF_CAP).
extern "C" int lgbt_wave_apply(const void* dec, const void* lor_in,
                               const void* table, void* lor_out,
                               void* slot_out, long long N, int Kd,
                               int leaf_cap, int num_sms, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  wave_apply_kernel<<<lgbt_grid(N, num_sms, 8), LGBT_THREADS, 0, st>>>(
      (const int8_t*)dec, (const int*)lor_in, (const int*)table,
      (int*)lor_out, (int*)slot_out, N, Kd, leaf_cap);
  return (int)cudaGetLastError();
}
