// Tiles of tail_x1_kernel (csrc/tail_x1.cuh) side by side, for
// tune_tail_x1.py: the library's own and the variants they were chosen
// over.  Built by that script (not into the kernel library) twice, with
// -DTUNE_ROWTAIL=0 for the mega-tail's y and 1 for the row tail's.
#if TUNE_ROWTAIL
#include "mrla_rowtail.cu"
namespace {
using Y = RowTailY;
}
#define TUNE_NAME(x) x##_rowtail
#else
#include "mrla_megatail.cu"
namespace {
using Y = EpilogueY;
}
#define TUNE_NAME(x) x##_megatail
#endif

namespace {

// X1Tile<WM, MT, NT, KC, MINB, YU, WG>; names in tune_tail_x1.py
template <class F>
int with_variant(int v, F&& f) {
  switch (v) {
    case 0: return f(X1Tile64x64{});
    case 1: return f(X1Tile64x128{});
    case 2: return f(X1Tile<1, 3, 2, 32, 1, 2, 0>{});
    case 3: return f(X1Tile<4, 1, 4, 64, 2, 1, 0>{});
    case 4: return f(X1Tile<2, 2, 4, 64, 1, 2, 0>{});
    case 5: return f(X1Tile<4, 1, 4, 64, 2, 0, 1>{});
    case 6: return f(X1Tile<2, 2, 4, 64, 1, 0, 1>{});
    case 7: return f(X1Tile<1, 3, 2, 32, 1, 0, 0>{});
    case 8: return f(X1Tile<2, 1, 4, 64, 2, 0, 0>{});
    default: return -1;
  }
}

}  // namespace

// y and x1 at (B, H, W, C, C1) with variant v; -1 where its tile does not
// take (C, C1).
extern "C" int TUNE_NAME(tune_x1)(int v, const void* out, const void* id,
                                  const void* gate, const void* wv,
                                  const void* lam, const void* scale,
                                  const void* bias, const void* w1,
                                  const void* b1, void* y, void* x1, int B,
                                  int H, int W, int C, int C1, void* stream) {
  TailArgs a{static_cast<const __nv_bfloat16*>(out),
             static_cast<const __nv_bfloat16*>(id),
             static_cast<const float*>(gate), static_cast<const float*>(wv),
             static_cast<const float*>(lam), static_cast<const float*>(scale),
             static_cast<const float*>(bias), H, W, C};
  return with_variant(v, [&](auto t) -> int {
    using T = decltype(t);
    if (C % 64 || T::smem_bytes(C) > kMaxSmem || C1 % T::CN) return -1;
    return (int)tail_x1_launch<Y, T>(a, w1, b1, y, x1, (int64_t)B * H * W,
                                     C1, static_cast<cudaStream_t>(stream));
  });
}

// tail_x1_describe's six numbers for variant v at C channels.
extern "C" int TUNE_NAME(tune_x1_describe)(int v, int C, int* out) {
  return with_variant(v, [&](auto t) -> int {
    using T = decltype(t);
    if (T::smem_bytes(C) > kMaxSmem) return -1;
    return (int)tail_x1_describe<Y, T>(C, out);
  });
}
