// Native host-side helpers for radler_tpu.
//
// The device compute path is JAX/XLA; these are the genuinely sequential
// host-runtime pieces that the reference implements in C++ and that are slow
// in pure Python:
//   * the minimum-|flux| Dijkstra divider used for facet boundaries
//     (behavioral equivalent of cpp/math/dijkstra_splitter.cc:34-142),
//   * run-length mask compression (equivalent of
//     cpp/utils/compressed_mask_data.h),
//   * 2-D flood fill (equivalent of image_analysis.cc:251-333).
//
// Exposed with a plain C ABI and loaded from Python via ctypes
// (radler_tpu/utils/native.py).  Build: `make -C native`.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

struct Visit {
  double distance;
  int to_x, to_y;
  int from_x, from_y;
  bool operator<(const Visit& other) const {
    // std::priority_queue is a max-heap; we need the smallest distance first.
    return distance > other.distance;
  }
};

}  // namespace

extern "C" {

// Finds the minimum-|flux| top-to-bottom path within columns [x1, x2) and
// writes 1.0 along it into `output` (zeroing the rest of those columns).
void radler_dijkstra_divide_vertically(const float* image, float* output,
                                       int width, int height, int x1, int x2) {
  const int span = x2 - x1;
  std::vector<double> dist(static_cast<size_t>(height) * span,
                           std::numeric_limits<double>::infinity());
  std::vector<int> prev_x(static_cast<size_t>(height) * span, -1);
  std::vector<int> prev_y(static_cast<size_t>(height) * span, -1);

  std::priority_queue<Visit> visits;
  for (int x = x1; x < x2; ++x) {
    visits.push(Visit{0.0, x, 0, x, 0});
  }
  int final_from_x = x1, final_from_y = 0;
  while (!visits.empty()) {
    Visit visit = visits.top();
    visits.pop();
    const int x = visit.to_x;
    const int y = visit.to_y;
    if (y == height) {
      final_from_x = visit.from_x;
      final_from_y = visit.from_y;
      break;
    }
    const size_t index = static_cast<size_t>(y) * span + (x - x1);
    const double new_distance =
        visit.distance + std::fabs(image[static_cast<size_t>(y) * width + x]);
    if (new_distance < dist[index]) {
      dist[index] = new_distance;
      prev_x[index] = visit.from_x;
      prev_y[index] = visit.from_y;
      Visit next{new_distance, 0, 0, x, y};
      if (x > x1) {
        next.to_x = x - 1;
        next.to_y = y + 1;
        visits.push(next);
        next.to_y = y;
        visits.push(next);
      }
      next.to_x = x;
      next.to_y = y + 1;
      visits.push(next);
      if (x < x2 - 1) {
        next.to_x = x + 1;
        next.to_y = y + 1;
        visits.push(next);
        next.to_y = y;
        visits.push(next);
      }
    }
  }
  for (int y = 0; y < height; ++y) {
    std::fill(output + static_cast<size_t>(y) * width + x1,
              output + static_cast<size_t>(y) * width + x2, 0.0f);
  }
  int px = final_from_x, py = final_from_y;
  while (py > 0) {
    output[static_cast<size_t>(py) * width + px] = 1.0f;
    const size_t index = static_cast<size_t>(py) * span + (px - x1);
    const int nx = prev_x[index];
    const int ny = prev_y[index];
    px = nx;
    py = ny;
  }
  output[px] = 1.0f;
}

// Run-length encode a boolean mask (alternating-run counts; 1/3/9-byte count
// encoding, same format as the reference's CompressedMaskData).  Returns the
// number of bytes written, or -1 if out_capacity was insufficient.
// first_value receives the value of the first run.
long long radler_rle_compress(const uint8_t* mask, long long n,
                              uint8_t* out, long long out_capacity,
                              uint8_t* first_value) {
  if (n <= 0) return 0;
  long long pos = 0;
  *first_value = mask[0];
  uint8_t current = mask[0];
  uint64_t count = 0;
  auto push_count = [&](uint64_t c) -> bool {
    if (c < 255) {
      if (pos + 1 > out_capacity) return false;
      out[pos++] = static_cast<uint8_t>(c);
    } else if (c < 65536) {
      if (pos + 3 > out_capacity) return false;
      out[pos++] = 255;
      out[pos++] = static_cast<uint8_t>(c % 256u);
      out[pos++] = static_cast<uint8_t>(c / 256u);
    } else {
      if (pos + 9 > out_capacity) return false;
      out[pos++] = 0;
      std::memcpy(out + pos, &c, 8);
      pos += 8;
    }
    return true;
  };
  for (long long i = 0; i < n; ++i) {
    if (mask[i] != current) {
      if (!push_count(count)) return -1;
      current = mask[i];
      count = 0;
    }
    ++count;
  }
  if (!push_count(count)) return -1;
  return pos;
}

// Decode an RLE buffer produced by radler_rle_compress into n booleans.
// Returns 0 on success, -1 on malformed input.
int radler_rle_decompress(const uint8_t* data, long long data_size,
                          uint8_t first_value, uint8_t* mask, long long n) {
  long long pos = 0;
  long long out = 0;
  uint8_t value = first_value;
  while (out < n) {
    if (pos >= data_size) return -1;
    uint64_t count;
    const uint8_t head = data[pos++];
    if (head == 255) {
      if (pos + 2 > data_size) return -1;
      count = data[pos] + 256u * data[pos + 1];
      pos += 2;
    } else if (head == 0) {
      if (pos + 8 > data_size) return -1;
      std::memcpy(&count, data + pos, 8);
      pos += 8;
    } else {
      count = head;
    }
    if (out + static_cast<long long>(count) > n) return -1;
    std::memset(mask + out, value, count);
    out += count;
    value = !value;
  }
  return 0;
}

// 4-connected flood fill of |image| > threshold (threshold >= 0) or the
// reference's signed rule (threshold < 0), starting from (x, y).  Marks
// visited pixels in `mask` (uint8).  Returns the area size.
long long radler_floodfill_2d(const float* image, uint8_t* mask,
                              float threshold, int x, int y, int width,
                              int height, int use_abs) {
  auto exceeds = [&](float v) -> bool {
    if (use_abs) return std::fabs(v) > threshold;
    if (threshold >= 0.0f) return v > threshold;
    return v < threshold || v > -threshold;
  };
  std::vector<std::pair<int, int>> todo;
  todo.emplace_back(x, y);
  mask[static_cast<size_t>(y) * width + x] = 1;
  long long area = 0;
  while (!todo.empty()) {
    auto [cx, cy] = todo.back();
    todo.pop_back();
    ++area;
    const size_t index = static_cast<size_t>(cy) * width + cx;
    if (cx > 0 && !mask[index - 1] && exceeds(image[index - 1])) {
      mask[index - 1] = 1;
      todo.emplace_back(cx - 1, cy);
    }
    if (cx < width - 1 && !mask[index + 1] && exceeds(image[index + 1])) {
      mask[index + 1] = 1;
      todo.emplace_back(cx + 1, cy);
    }
    if (cy > 0 && !mask[index - width] && exceeds(image[index - width])) {
      mask[index - width] = 1;
      todo.emplace_back(cx, cy - 1);
    }
    if (cy < height - 1 && !mask[index + width] &&
        exceeds(image[index + width])) {
      mask[index + width] = 1;
      todo.emplace_back(cx, cy + 1);
    }
  }
  return area;
}

}  // extern "C"
