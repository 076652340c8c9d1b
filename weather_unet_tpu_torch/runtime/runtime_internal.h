// Internal interfaces shared between the native runtime translation units.
#ifndef WUT_RUNTIME_INTERNAL_H_
#define WUT_RUNTIME_INTERNAL_H_

#include <cstdint>
#include <vector>

namespace wut {

// Decode a JPEG to RGB u8 HWC.  `target_hint > 0` enables DCT-domain
// downscale to the smallest scale that keeps max(h, w) >= 2 * target_hint
// (quality-preserving speedup for the resize/augment pass that follows).
// Returns 0 on success; fills `rgb` (h * w * 3) and `h`, `w`.
int DecodeToRgb(const char* path, int target_hint, std::vector<uint8_t>* rgb,
                int* h, int* w);

}  // namespace wut

#endif  // WUT_RUNTIME_INTERNAL_H_
