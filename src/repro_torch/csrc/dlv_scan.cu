// DLV Algorithm-5 cut scan for Hopper (sm_90a).
//
// Replaces the jitted JAX column scan repro/core/dlv.py::_dlv_scan_cols
// (the TPU branch of _seg_cuts).  Each segment of the concatenated array
// vals (sorted, centred on its own mean) is scanned in order with
// Kahan-compensated running count / sum / sum of squares; a cut is placed
// before x_i when the running variance including x_i exceeds the
// segment's beta (never at a segment's first row), and the stats restart
// at x_i.  The arithmetic is the reference host twin _scan_cols_np's,
// operation for operation; the file is built with -fmad=false so that
// nvcc does not contract x*x - c2 or t2/k1 - mean*mean into FMAs, which
// would change the rounding and move a cut that lies near beta.
//
// Bound: the scan is a serial dependency chain per segment (two f64
// divisions per row), not memory.  Design: one thread per segment; no
// pow2-padded dense matrix (that existed only to bound JAX's jit shapes).
// A thread loads PF rows into registers before it scans them, so the
// loads of a batch are in flight together instead of one DRAM round trip
// per row.  A round with one long segment is one thread's serial loop --
// a known cost; a parallel cut-to-cut jump scan is later work.
#include <cuda_runtime.h>
#include <stdint.h>

#define PF 16

__global__ void dlv_scan_kernel(const double* __restrict__ vals,
                                const int64_t* __restrict__ starts,
                                const int64_t* __restrict__ lens,
                                const double* __restrict__ beta,
                                int64_t nseg, uint8_t* __restrict__ cuts) {
  const int64_t sg = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (sg >= nseg) return;
  const int64_t a = starts[sg];
  const int64_t L = lens[sg];
  const double B = beta[sg];
  double k = 0.0, s1 = 0.0, c1 = 0.0, s2 = 0.0, c2 = 0.0;
  for (int64_t i0 = 0; i0 < L; i0 += PF) {
    const int64_t cnt = L - i0 < PF ? L - i0 : PF;
    double xs[PF];
#pragma unroll
    for (int u = 0; u < PF; ++u) xs[u] = u < cnt ? vals[a + i0 + u] : 0.0;
#pragma unroll
    for (int u = 0; u < PF; ++u) {
      if (u >= cnt) break;
      const double x = xs[u];
      const double k1 = k + 1.0;
      const double x2 = x * x;
      const double y1 = x - c1;
      const double t1 = s1 + y1;
      const double c1n = (t1 - s1) - y1;
      const double y2 = x2 - c2;
      const double t2 = s2 + y2;
      const double c2n = (t2 - s2) - y2;
      const double mean = t1 / k1;
      const double var = t2 / k1 - mean * mean;
      const bool cut = (var > B) && (k > 0.0);
      cuts[a + i0 + u] = cut ? 1 : 0;
      if (cut) {
        k = 1.0; s1 = x; c1 = 0.0; s2 = x2; c2 = 0.0;
      } else {
        k = k1; s1 = t1; c1 = c1n; s2 = t2; c2 = c2n;
      }
    }
  }
}

extern "C" int dlv_scan_f64(const void* vals, const void* starts,
                            const void* lens, const void* beta, int64_t nseg,
                            void* cuts, void* stream) {
  if (nseg <= 0) return (int)cudaGetLastError();
  const int threads = 128;
  const unsigned blocks = (unsigned)((nseg + threads - 1) / threads);
  dlv_scan_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const double*)vals, (const int64_t*)starts, (const int64_t*)lens,
      (const double*)beta, nseg, (uint8_t*)cuts);
  return (int)cudaGetLastError();
}
