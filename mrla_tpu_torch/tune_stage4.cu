// The stage kernel (csrc/mrla_stage4.cu) a launch at a time, for
// tune_stage4.py: this file includes the library's source and exports its
// steps one by one.  Built by that script, not into the kernel library.
#include "mrla_stage4.cu"

// Steps [first, last) of the eight (0 id0; 1 z0 and block 0's tail; 2, 3 x1
// and o of block 1; 4 its z and tail; 5, 6, 7 block 2's); the other
// arguments as mrla_stage4_bf16's.
extern "C" int tune_stage4_steps(
    const void* ob, const void* xs, long long xs_sB, long long xs_sH,
    long long xs_sW, const void* kd, const void* k3_0, const void* k1,
    const void* k2, const void* k3, const void* bd, const void* b3_0,
    const void* b1, const void* b2, const void* b3, const void* wq,
    const void* wk, const void* wv, const void* lam, const void* scale,
    const void* bias, void* f32, void* yb, void* x1o, void* y, int B, int CIN,
    int C1, int C, int heads, int ktap, int first, int last, void* stream) {
  if (!supported(B, CIN, C1, C, heads, ktap) || first < 0 || last > kSteps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Stage4Args a = args_of(ob, xs, xs_sB, xs_sH, xs_sW, kd, k3_0, k1, k2,
                               k3, bd, b3_0, b1, b2, b3, wq, wk, wv, lam,
                               scale, bias, f32, yb, x1o, y, B, CIN, C1, C,
                               heads, ktap);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int step = first; step < last; ++step) {
    const cudaError_t err = run_step(a, step, s);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
