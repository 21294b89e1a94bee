// Native data-plane kernels for the eager core: the port's own copy of
// horovod_tpu/native/kernels.cc, built by horovod_tpu_torch/native at
// first use.
//
// TPU-native equivalent of the reference's C++ core hot paths:
//  - fused-buffer pack/unpack      (reference: horovod/common/ops/
//    collective_operations.cc MemcpyInFusionBuffer/MemcpyOutFusionBuffer
//    and ops/cuda/cuda_kernels.cu batched memcpy)
//  - buffer scaling                (reference: collective_operations.h:89-125
//    ScaleBuffer, incl. the fp16 AVX path — here fp16/bf16 via fp32 widening,
//    autovectorized by -O3 -march=native)
//  - ring allreduce over TCP fds   (reference: ops/gloo_operations.cc ring
//    allreduce; same reduce-scatter + allgather schedule as the Python
//    fallback in backend/tcp.py, byte-compatible wire layout)
//  - Adasum combine primitives     (reference: ops/adasum/adasum.h:38-552
//    per-layer dot products / norms and scale-insensitive combine)
//
// Exposed as a plain C ABI for ctypes (the reference loads its core the same
// way: horovod/common/basics.py ctypes.CDLL).
#include <cerrno>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include <poll.h>
#include <sys/socket.h>
#include <sys/types.h>

extern "C" {

// ---------------------------------------------------------------------------
// Fusion buffer pack / unpack
// ---------------------------------------------------------------------------
void hvd_pack(const void** srcs, const int64_t* nbytes, int32_t n,
              char* dst) {
  int64_t offset = 0;
  for (int32_t i = 0; i < n; ++i) {
    if (srcs[i] != nullptr) {
      std::memcpy(dst + offset, srcs[i], (size_t)nbytes[i]);
    } else {
      std::memset(dst + offset, 0, (size_t)nbytes[i]);  // joined-rank zeros
    }
    offset += nbytes[i];
  }
}

void hvd_unpack(const char* src, const int64_t* nbytes, int32_t n,
                void** dsts) {
  int64_t offset = 0;
  for (int32_t i = 0; i < n; ++i) {
    std::memcpy(dsts[i], src + offset, (size_t)nbytes[i]);
    offset += nbytes[i];
  }
}

// ---------------------------------------------------------------------------
// Buffer scaling
// ---------------------------------------------------------------------------
void hvd_scale_f32(float* buf, int64_t n, float factor) {
  for (int64_t i = 0; i < n; ++i) buf[i] *= factor;
}

void hvd_scale_f64(double* buf, int64_t n, double factor) {
  for (int64_t i = 0; i < n; ++i) buf[i] *= factor;
}

// ---------------------------------------------------------------------------
// Socket helpers: exact-size send/recv that tolerate O_NONBLOCK fds
// (Python sockets with timeouts are non-blocking underneath).
// ---------------------------------------------------------------------------
static int poll_wait(int fd, short events) {
  struct pollfd p;
  p.fd = fd;
  p.events = events;
  for (;;) {
    int r = poll(&p, 1, 60000 /* ms */);
    if (r > 0) return 0;
    if (r == 0) return -1;              // timeout
    if (errno != EINTR) return -1;
  }
}

// Wire format: every message is a 4-byte big-endian length prefix followed
// by the payload — byte-identical to runner/network.py send_msg/recv_msg,
// so a rank on the native path interoperates with a rank on the Python
// fallback (mixed toolchains must not corrupt the ring).
static int send_exact(int fd, const char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t w = send(fd, buf + off, n - off, MSG_NOSIGNAL);
    if (w > 0) {
      off += (size_t)w;
    } else if (w < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (poll_wait(fd, POLLOUT) != 0) return -1;
    } else if (w < 0 && errno == EINTR) {
      continue;
    } else {
      return -1;
    }
  }
  return 0;
}

static int recv_exact(int fd, char* buf, size_t n) {
  size_t off = 0;
  while (off < n) {
    ssize_t r = recv(fd, buf + off, n - off, 0);
    if (r > 0) {
      off += (size_t)r;
    } else if (r < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      if (poll_wait(fd, POLLIN) != 0) return -1;
    } else if (r < 0 && errno == EINTR) {
      continue;
    } else {
      return -1;  // peer closed or hard error
    }
  }
  return 0;
}

}  // extern "C" (reopened below for the remaining entry points)

// ---------------------------------------------------------------------------
// Ring allreduce (sum) over raw fds
// ---------------------------------------------------------------------------
// dtype codes: 0=f32 1=f64 2=i32 3=i64
template <typename T>
static void add_into(T* dst, const T* src, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] += src[i];
}

template <typename T>
static int ring_allreduce_t(int send_fd, int recv_fd, T* buf, int64_t n,
                            int rank, int size) {
  // Chunk layout identical to backend/tcp.py: first `rem` chunks get one
  // extra element.
  int64_t base = n / size, rem = n % size;
  std::vector<int64_t> bounds(size + 1, 0);
  for (int i = 0; i < size; ++i)
    bounds[i + 1] = bounds[i] + base + (i < rem ? 1 : 0);

  int64_t max_chunk = base + (rem ? 1 : 0);
  // Uninitialized staging (std::vector would memset a chunk-sized block
  // per op — 32 MB of pure overhead on a 64 MB payload).
  std::unique_ptr<T[]> incoming(new T[(size_t)max_chunk]);

  // Inline-send ceiling: the lesser of 64 KB and half the smaller actual
  // kernel buffer (the 4 MB SO_SNDBUF request in PeerMesh may have been
  // clamped by tcp_wmem); a blocking sendall below this bound cannot
  // deadlock the ring even when no peer is mid-recv.
  size_t inline_max = 64 * 1024;
  {
    int sb = 0, rb = 0;
    socklen_t sl = sizeof(sb);
    if (getsockopt(send_fd, SOL_SOCKET, SO_SNDBUF, &sb, &sl) == 0 &&
        getsockopt(recv_fd, SOL_SOCKET, SO_RCVBUF, &rb,
                   (sl = sizeof(rb), &sl)) == 0) {
      size_t floor_bytes = (size_t)(sb < rb ? sb : rb) / 2;
      if (floor_bytes < inline_max) inline_max = floor_bytes;
    }
  }

  // Reduce-scatter, then allgather.  Concurrent send/recv per step so the
  // ring cannot deadlock on filled socket buffers.
  for (int phase = 0; phase < 2; ++phase) {
    for (int step = 0; step < size - 1; ++step) {
      int send_idx = phase == 0 ? (rank - step) % size
                                : (rank + 1 - step) % size;
      int recv_idx = phase == 0 ? (rank - step - 1) % size
                                : (rank - step) % size;
      if (send_idx < 0) send_idx += size;
      if (recv_idx < 0) recv_idx += size;

      const char* send_ptr = (const char*)(buf + bounds[send_idx]);
      size_t send_bytes =
          (size_t)(bounds[send_idx + 1] - bounds[send_idx]) * sizeof(T);
      int64_t recv_elems = bounds[recv_idx + 1] - bounds[recv_idx];
      size_t recv_bytes = (size_t)recv_elems * sizeof(T);

      unsigned char send_hdr[4] = {
          (unsigned char)(send_bytes >> 24), (unsigned char)(send_bytes >> 16),
          (unsigned char)(send_bytes >> 8), (unsigned char)send_bytes};

      // Small chunks: sequential send-then-recv below the inline ceiling
      // (skipping the per-step std::thread saves ~0.5 ms/op, which
      // dominates small-tensor cached-cycle latency).  Large chunks keep
      // the concurrent sender thread so the ring cannot deadlock on
      // filled buffers.
      auto do_send = [&]() -> int {
        int rc = send_exact(send_fd, (const char*)send_hdr, 4);
        if (rc == 0) rc = send_exact(send_fd, send_ptr, send_bytes);
        return rc;
      };
      int send_rc_val = 0, recv_rc = -1;
      bool threaded = send_bytes > inline_max;
      std::thread sender;
      if (threaded) {
        // join() below synchronizes the plain write.
        sender = std::thread([&] { send_rc_val = do_send(); });
      } else {
        send_rc_val = do_send();
      }
      // Inline path: a dead link already failed the send — skip the recv
      // (its own 60 s poll timeout would double time-to-error).
      if (threaded || send_rc_val == 0) {
        unsigned char recv_hdr[4];
        recv_rc = recv_exact(recv_fd, (char*)recv_hdr, 4);
        if (recv_rc == 0) {
          size_t framed = ((size_t)recv_hdr[0] << 24) |
                          ((size_t)recv_hdr[1] << 16) |
                          ((size_t)recv_hdr[2] << 8) | (size_t)recv_hdr[3];
          if (framed != recv_bytes) {
            recv_rc = -1;  // peer desync: fail loudly, never misparse
          } else if (phase == 0) {
            // PIPELINED reduce: consume the incoming chunk in ~256 KB
            // segments, adding each into the accumulator while the NIC
            // (and the peer's sender) stream the next segment into the
            // kernel buffer — on a real network the adds ride entirely
            // inside the transfer time instead of serializing after it.
            constexpr size_t kSeg = 256 * 1024;
            T* dst = buf + bounds[recv_idx];
            size_t done = 0;
            recv_rc = 0;
            while (done < recv_bytes && recv_rc == 0) {
              size_t seg = recv_bytes - done;
              if (seg > kSeg) seg = kSeg;
              recv_rc = recv_exact(
                  recv_fd, (char*)incoming.get() + done, seg);
              if (recv_rc == 0) {
                add_into(dst + done / sizeof(T),
                         (const T*)((const char*)incoming.get() + done),
                         (int64_t)(seg / sizeof(T)));
                done += seg;
              }
            }
          } else {
            // Allgather phase: no compute to overlap; one bulk recv
            // straight into place (no staging copy).
            recv_rc = recv_exact(recv_fd, (char*)(buf + bounds[recv_idx]),
                                 recv_bytes);
          }
        }
      }
      if (threaded) sender.join();
      if (send_rc_val != 0 || recv_rc != 0) return -1;
    }
  }
  return 0;
}

extern "C" {

int32_t hvd_ring_allreduce(int32_t send_fd, int32_t recv_fd, void* buf,
                           int64_t n, int32_t dtype, int32_t rank,
                           int32_t size) {
  if (size <= 1) return 0;
  switch (dtype) {
    case 0: return ring_allreduce_t(send_fd, recv_fd, (float*)buf, n, rank, size);
    case 1: return ring_allreduce_t(send_fd, recv_fd, (double*)buf, n, rank, size);
    case 2: return ring_allreduce_t(send_fd, recv_fd, (int32_t*)buf, n, rank, size);
    case 3: return ring_allreduce_t(send_fd, recv_fd, (int64_t*)buf, n, rank, size);
    default: return -2;
  }
}

// ---------------------------------------------------------------------------
// Fused codec kernels (compress/fused.py native half; EQuARX-style
// blockwise affine quantization, arXiv:2506.17615 + arXiv:2305.06942).
//
// THE single-pass computation-collective kernels: hvd_qdecode with
// accumulate=1 consumes an arriving wire segment and updates the fp32
// accumulator in place — dequantize and reduce in ONE loop over the
// payload — and hvd_qencode requantizes an accumulator straight into a
// contiguous wire image (scales || zero_points || payload, the exact
// compress/quantize.py layout).
//
// Bit-exactness contract with the numpy reference (compress/quantize.py):
// identical IEEE fp32 operations in identical order — subtract, divide,
// rintf (round-half-even, = np.rint), clip, truncating uint8 cast on the
// way in; multiply, add, accumulate-add on the way out.  The build passes
// -ffp-contract=off so the compiler cannot fuse the q*scale+zp
// multiply-add into an FMA (numpy rounds between the two ops; an FMA
// would not).  Tail blocks follow the same pad rule (padding repeats the
// block's own last element, so min/max are unchanged and only `count`
// real elements are coded); odd-length uint4 payloads zero the pad
// nibble, byte-identical to the numpy packer.
// ---------------------------------------------------------------------------
extern "C" {

int32_t hvd_qencode(const float* x, int64_t n, int32_t block_size,
                    int32_t levels, int32_t pack4, uint8_t* wire) {
  if (n <= 0 || block_size <= 0) return 0;
  int64_t nb = (n + block_size - 1) / block_size;
  uint8_t* sp = wire;                 // per-block scales   (fp32)
  uint8_t* zpp = wire + nb * 4;       // per-block zero pts (fp32)
  uint8_t* pl = wire + nb * 8;        // packed levels
  const float maxq = (float)(levels - 1);
  for (int64_t b = 0; b < nb; ++b) {
    int64_t start = b * block_size;
    int64_t count = n - start;
    if (count > block_size) count = block_size;
    float lo = x[start], hi = x[start];
    for (int64_t i = 1; i < count; ++i) {
      float v = x[start + i];
      if (v < lo) lo = v;
      if (v > hi) hi = v;
    }
    float scale = (hi - lo) / maxq;
    if (!(scale > 0.0f)) scale = 1.0f;   // flat (or NaN) block
    std::memcpy(sp + b * 4, &scale, 4);
    std::memcpy(zpp + b * 4, &lo, 4);
    if (!pack4) {
      for (int64_t i = 0; i < count; ++i) {
        float q = rintf((x[start + i] - lo) / scale);
        if (q < 0.0f) q = 0.0f;
        else if (q > maxq) q = maxq;
        pl[start + i] = (uint8_t)q;
      }
    } else {
      // block_size is even by config validation, so nibble pairs never
      // straddle blocks; an odd GLOBAL tail zeroes its pad nibble.
      int64_t i = 0;
      for (; i + 1 < count; i += 2) {
        float qa = rintf((x[start + i] - lo) / scale);
        float qb = rintf((x[start + i + 1] - lo) / scale);
        if (qa < 0.0f) qa = 0.0f; else if (qa > maxq) qa = maxq;
        if (qb < 0.0f) qb = 0.0f; else if (qb > maxq) qb = maxq;
        pl[(start + i) >> 1] =
            (uint8_t)(((uint8_t)qa << 4) | (uint8_t)qb);
      }
      if (i < count) {
        float qa = rintf((x[start + i] - lo) / scale);
        if (qa < 0.0f) qa = 0.0f; else if (qa > maxq) qa = maxq;
        pl[(start + i) >> 1] = (uint8_t)((uint8_t)qa << 4);
      }
    }
  }
  return 0;
}

int32_t hvd_qdecode(const uint8_t* wire, int64_t n, int32_t block_size,
                    int32_t pack4, float* dst, int32_t accumulate) {
  if (n <= 0 || block_size <= 0) return 0;
  int64_t nb = (n + block_size - 1) / block_size;
  const uint8_t* sp = wire;
  const uint8_t* zpp = wire + nb * 4;
  const uint8_t* pl = wire + nb * 8;
  for (int64_t b = 0; b < nb; ++b) {
    int64_t start = b * block_size;
    int64_t count = n - start;
    if (count > block_size) count = block_size;
    float scale, zp;
    std::memcpy(&scale, sp + b * 4, 4);   // wire may be unaligned (shm
    std::memcpy(&zp, zpp + b * 4, 4);     // regions slice at odd offsets)
    if (accumulate) {
      for (int64_t i = 0; i < count; ++i) {
        int64_t g = start + i;
        uint8_t q = pack4 ? (uint8_t)((g & 1) ? pl[g >> 1] & 0x0F
                                              : pl[g >> 1] >> 4)
                          : pl[g];
        float v = (float)q * scale;       // separate mul + add: numpy
        v = v + zp;                       // rounds between them (no FMA)
        dst[g] += v;
      }
    } else {
      for (int64_t i = 0; i < count; ++i) {
        int64_t g = start + i;
        uint8_t q = pack4 ? (uint8_t)((g & 1) ? pl[g >> 1] & 0x0F
                                              : pl[g >> 1] >> 4)
                          : pl[g];
        float v = (float)q * scale;
        v = v + zp;
        dst[g] = v;
      }
    }
  }
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Adasum primitives (reference: ops/adasum/adasum.h ComputeDotAndNormSqrds
// and ScaledAdd — the per-layer statistics and the scale-insensitive combine)
// ---------------------------------------------------------------------------
void hvd_dot_norms_f64(const double* a, const double* b, int64_t n,
                       double* out3 /* dot, normsq_a, normsq_b */) {
  double dot = 0, na = 0, nb = 0;
  for (int64_t i = 0; i < n; ++i) {
    dot += a[i] * b[i];
    na += a[i] * a[i];
    nb += b[i] * b[i];
  }
  out3[0] = dot;
  out3[1] = na;
  out3[2] = nb;
}

void hvd_scaled_add_f64(double* a, const double* b, int64_t n,
                        double ca, double cb) {
  for (int64_t i = 0; i < n; ++i) a[i] = ca * a[i] + cb * b[i];
}

int32_t hvd_abi_version(void) { return 1; }

}  // extern "C"
