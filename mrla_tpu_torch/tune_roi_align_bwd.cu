// Shapes of the RoIAlign backward's tile pass (csrc/roi_align.cu) side by
// side, each block's cycles written out by phase, for tune_roi_align_bwd.py:
// the library's shape and the ones it was chosen over.  Built by that
// script, not into the kernel library.
#include "roi_align.cu"

namespace {

// TileShape<channels a block, 8-channel vectors a thread, chains of sums>;
// names in tune_roi_align_bwd.py
template <class F>
cudaError_t with_shape(int v, F&& f) {
  switch (v) {
    case 0: return f(LibTile{});
    case 1: return f(TileShape<256, 4, 1>{});
    case 2: return f(TileShape<128, 2, 1>{});
    case 3: return f(TileShape<64, 2, 2>{});
    case 4: return f(TileShape<64, 1, 2>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// roi_align_bwd with tile shape v; clocks [slices][B][tiles][6] int64 (see
// roi_align_bwd_tiles).
extern "C" int tune_roi_bwd(int v, void* grad0, void* grad1, void* grad2,
                            void* grad3, int h0, int w0, int h1, int w1,
                            int h2, int w2, int h3, int w3, int L,
                            const void* geom, const void* g, void* scratch,
                            int B, int P, int C, int O, int smax,
                            void* clocks, void* stream) {
  const GradLevels lv{{static_cast<float*>(grad0), static_cast<float*>(grad1),
                       static_cast<float*>(grad2), static_cast<float*>(grad3)},
                      {h0, h1, h2, h3},
                      {w0, w1, w2, w3},
                      {},
                      {},
                      L};
  if (!bwd_args_ok(lv, B, P, C, O, smax)) return (int)cudaErrorInvalidValue;
  return (int)with_shape(v, [&](auto t) {
    return launch_bwd<decltype(t), true>(
        lv, geom, g, scratch, B, P, C, O, smax,
        static_cast<long long*>(clocks), static_cast<cudaStream_t>(stream));
  });
}

// Channels a block of shape v (its channel slices: ceil(C / that)).
extern "C" int tune_roi_bwd_channels(int v) {
  int cs = 0;
  with_shape(v, [&](auto t) {
    cs = decltype(t)::CS;
    return cudaSuccess;
  });
  return cs;
}
