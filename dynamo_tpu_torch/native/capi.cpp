// C API for native engine workers: KV-event publishing into the control
// plane, without Python in the loop.
//
// Copied from dynamo_tpu/native/capi.cpp: dyn_llm_init,
// dyn_kv_event_publish_stored / _removed, dyn_llm_shutdown and
// dyn_tokens_hash, with the same signatures. It speaks the control plane's
// own length-prefixed msgpack wire (runtime/transports/wire.py) straight to
// the server's `publish` op, onto the subject `{ns}.{component}.kv_events`
// that the KV router subscribes to (kv_router/publisher.py).
//
// Hashing matches dynamo_tpu_torch/engine/kv_cache.py: tokens_hash is
// BLAKE2b with an 8-byte digest, keyed with "dynamo-tokens-1337", over each
// token id as 4 little-endian bytes, the digest read little-endian. The
// keyed BLAKE2b of RFC 7693 is written out below, so nothing is linked
// (the JAX package's twin links libxxhash for its xxh3 recipe).
//
// Thread model: one blocking socket guarded by a mutex; every publish
// awaits the server's ack frame (so errors surface and the socket can't
// fill unobserved).
#include <arpa/inet.h>
#include <fcntl.h>
#include <netdb.h>
#include <poll.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>

namespace {

// -- BLAKE2b (RFC 7693), keyed, 8-byte digest --------------------------------

constexpr uint64_t kIv[8] = {
    0x6a09e667f3bcc908ull, 0xbb67ae8584caa73bull, 0x3c6ef372fe94f82bull,
    0xa54ff53a5f1d36f1ull, 0x510e527fade682d1ull, 0x9b05688c2b3e6c1full,
    0x1f83d9abfb41bd6bull, 0x5be0cd19137e2179ull};

constexpr uint8_t kSigma[12][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3},
    {11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4},
    {7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8},
    {9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13},
    {2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9},
    {12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11},
    {13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10},
    {6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5},
    {10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0},
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3}};

// the key of engine/kv_cache.py tokens_hash
constexpr char kTokensKey[] = "dynamo-tokens-1337";

inline uint64_t rotr64(uint64_t x, int n) { return (x >> n) | (x << (64 - n)); }

// F: compress one 128-byte block into h; t is the byte count so far
// (this block included), last marks the final block
void blake2b_compress(uint64_t h[8], const uint8_t block[128], uint64_t t,
                      bool last) {
  uint64_t m[16], v[16];
  for (int i = 0; i < 16; ++i) {
    uint64_t w = 0;
    for (int b = 7; b >= 0; --b) w = (w << 8) | block[8 * i + b];
    m[i] = w;
  }
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kIv[i];
  }
  v[12] ^= t;  // the high word of the counter stays 0: messages < 2^64 B
  if (last) v[14] = ~v[14];
  auto g = [&](int a, int b, int c, int d, uint64_t x, uint64_t y) {
    v[a] = v[a] + v[b] + x;
    v[d] = rotr64(v[d] ^ v[a], 32);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 24);
    v[a] = v[a] + v[b] + y;
    v[d] = rotr64(v[d] ^ v[a], 16);
    v[c] = v[c] + v[d];
    v[b] = rotr64(v[b] ^ v[c], 63);
  };
  for (int r = 0; r < 12; ++r) {
    const uint8_t* s = kSigma[r];
    g(0, 4, 8, 12, m[s[0]], m[s[1]]);
    g(1, 5, 9, 13, m[s[2]], m[s[3]]);
    g(2, 6, 10, 14, m[s[4]], m[s[5]]);
    g(3, 7, 11, 15, m[s[6]], m[s[7]]);
    g(0, 5, 10, 15, m[s[8]], m[s[9]]);
    g(1, 6, 11, 12, m[s[10]], m[s[11]]);
    g(2, 7, 8, 13, m[s[12]], m[s[13]]);
    g(3, 4, 9, 14, m[s[14]], m[s[15]]);
  }
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

// BLAKE2b-64 of data under key (key_len <= 64): the key block leads the
// message, the last block (partial or full) is compressed as final; the
// 8-byte digest read little-endian is h[0]
uint64_t blake2b64_keyed(const uint8_t* key, size_t key_len,
                         const uint8_t* data, size_t len) {
  uint64_t h[8];
  for (int i = 0; i < 8; ++i) h[i] = kIv[i];
  h[0] ^= 0x01010000ull ^ (static_cast<uint64_t>(key_len) << 8) ^ 8ull;
  std::vector<uint8_t> msg;
  msg.reserve((key_len ? 128 : 0) + len);
  if (key_len) {
    msg.assign(key, key + key_len);
    msg.resize(128, 0);
  }
  msg.insert(msg.end(), data, data + len);
  size_t total = msg.size();
  uint8_t block[128];
  size_t off = 0;
  while (total - off > 128) {
    blake2b_compress(h, msg.data() + off, off + 128, false);
    off += 128;
  }
  std::memset(block, 0, sizeof(block));
  std::memcpy(block, msg.data() + off, total - off);
  blake2b_compress(h, block, total, true);
  return h[0];
}

struct State {
  int fd = -1;
  std::string subject;    // "{ns}.{component}.kv_events"
  std::string worker_id;
  uint32_t block_size = 0;
  uint64_t next_msg_id = 2;  // 1 is conventionally the probe id elsewhere
  std::mutex mu;
};

State g_state;

// -- minimal msgpack writer (the subset the wire needs) ---------------------

void put_u8(std::string& b, uint8_t v) { b.push_back(static_cast<char>(v)); }

void put_be(std::string& b, uint64_t v, int bytes) {
  for (int i = bytes - 1; i >= 0; --i)
    b.push_back(static_cast<char>((v >> (8 * i)) & 0xff));
}

void pack_uint(std::string& b, uint64_t v) {
  if (v < 0x80) {
    put_u8(b, static_cast<uint8_t>(v));
  } else if (v <= 0xff) {
    put_u8(b, 0xcc); put_be(b, v, 1);
  } else if (v <= 0xffff) {
    put_u8(b, 0xcd); put_be(b, v, 2);
  } else if (v <= 0xffffffffull) {
    put_u8(b, 0xce); put_be(b, v, 4);
  } else {
    put_u8(b, 0xcf); put_be(b, v, 8);
  }
}

void pack_nil(std::string& b) { put_u8(b, 0xc0); }

void pack_str(std::string& b, const std::string& s) {
  if (s.size() < 32) {
    put_u8(b, 0xa0 | static_cast<uint8_t>(s.size()));
  } else if (s.size() <= 0xff) {
    put_u8(b, 0xd9); put_be(b, s.size(), 1);
  } else {
    put_u8(b, 0xda); put_be(b, s.size(), 2);
  }
  b.append(s);
}

void pack_bin(std::string& b, const std::string& payload) {
  if (payload.size() <= 0xff) {
    put_u8(b, 0xc4); put_be(b, payload.size(), 1);
  } else if (payload.size() <= 0xffff) {
    put_u8(b, 0xc5); put_be(b, payload.size(), 2);
  } else {
    put_u8(b, 0xc6); put_be(b, payload.size(), 4);
  }
  b.append(payload);
}

void pack_map_header(std::string& b, size_t n) {
  if (n < 16) put_u8(b, 0x80 | static_cast<uint8_t>(n));
  else { put_u8(b, 0xde); put_be(b, n, 2); }
}

void pack_array_header(std::string& b, size_t n) {
  if (n < 16) put_u8(b, 0x90 | static_cast<uint8_t>(n));
  else if (n <= 0xffff) { put_u8(b, 0xdc); put_be(b, n, 2); }
  else { put_u8(b, 0xdd); put_be(b, n, 4); }
}

// -- socket helpers ---------------------------------------------------------

bool send_all(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::send(fd, data, len, MSG_NOSIGNAL);
    if (n <= 0) return false;
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, char* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::recv(fd, data, len, 0);
    if (n <= 0) return false;
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Frame the body (4-byte big-endian length prefix — wire.py pack()), send,
// and await the ack frame. The server replies {"id": rid} on success and
// {"id": rid, "error": "..."} on failure; scanning for the fixstr-encoded
// key "\xa5error" is exact for msgpack-python's output (keys < 32 chars are
// always fixstr) and avoids a full decoder here.
// A transport failure (timeout included) leaves the stream position
// unknown, so the socket is closed: later publishes fail fast until the
// caller re-inits, rather than misparsing a half-read frame.
int fail_conn() {
  ::close(g_state.fd);
  g_state.fd = -1;
  return 1;
}

int transact(const std::string& body) {
  std::string framed;
  put_be(framed, body.size(), 4);
  framed.append(body);
  if (!send_all(g_state.fd, framed.data(), framed.size())) return fail_conn();
  char hdr[4];
  if (!recv_all(g_state.fd, hdr, 4)) return fail_conn();
  uint32_t len = (static_cast<uint8_t>(hdr[0]) << 24) |
                 (static_cast<uint8_t>(hdr[1]) << 16) |
                 (static_cast<uint8_t>(hdr[2]) << 8) |
                 static_cast<uint8_t>(hdr[3]);
  if (len > (64u << 20)) return fail_conn();
  std::vector<char> reply(len);
  if (!recv_all(g_state.fd, reply.data(), len)) return fail_conn();
  static const char kErrKey[] = "\xa5" "error";
  for (size_t i = 0; i + 6 <= reply.size(); ++i)
    if (std::memcmp(reply.data() + i, kErrKey, 6) == 0) return 1;
  return 0;
}

// RouterEvent.pack() twin (kv_router/protocols.py): the payload the
// Python KvIndexer unpacks, msgpack-encoded.
std::string pack_router_event(uint64_t event_id, const std::string& data_map) {
  std::string ev;
  pack_map_header(ev, 3);
  pack_str(ev, "worker_id"); pack_str(ev, g_state.worker_id);
  pack_str(ev, "event_id"); pack_uint(ev, event_id);
  pack_str(ev, "data"); ev.append(data_map);
  return ev;
}

int publish_payload(const std::string& event_payload) {
  std::string body;
  pack_map_header(body, 4);
  pack_str(body, "id"); pack_uint(body, g_state.next_msg_id++);
  pack_str(body, "op"); pack_str(body, "publish");
  pack_str(body, "subject"); pack_str(body, g_state.subject);
  pack_str(body, "payload"); pack_bin(body, event_payload);
  return transact(body);
}

}  // namespace

extern "C" {

// Compute the content-only page hash a router derives from query tokens
// (engine/kv_cache.py tokens_hash). Exposed so C++ allocators can key
// their own structures identically.
uint64_t dyn_tokens_hash(const uint32_t* token_ids, size_t num_tokens) {
  std::string bytes;
  bytes.reserve(num_tokens * 4);
  for (size_t i = 0; i < num_tokens; ++i) {
    uint32_t t = token_ids[i];
    bytes.push_back(static_cast<char>(t & 0xff));
    bytes.push_back(static_cast<char>((t >> 8) & 0xff));
    bytes.push_back(static_cast<char>((t >> 16) & 0xff));
    bytes.push_back(static_cast<char>((t >> 24) & 0xff));
  }
  return blake2b64_keyed(reinterpret_cast<const uint8_t*>(kTokensKey),
                         sizeof(kTokensKey) - 1,
                         reinterpret_cast<const uint8_t*>(bytes.data()),
                         bytes.size());
}

// Connect to the control plane and bind this worker's event subject.
// cp_host/cp_port locate the ControlPlaneServer; ns/component/worker_id are
// the worker's identity triple, kv_block_size the page geometry.
int dyn_llm_init(const char* ns, const char* component, const char* worker_id,
                 uint32_t kv_block_size, const char* cp_host, int cp_port) {
  std::lock_guard<std::mutex> lk(g_state.mu);
  if (g_state.fd >= 0) return 1;  // already initialized
  struct addrinfo hints = {};
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  std::string port_s = std::to_string(cp_port);
  if (getaddrinfo(cp_host, port_s.c_str(), &hints, &res) != 0 || !res)
    return 1;
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    // bounded connect: non-blocking + poll, so an unreachable control
    // plane costs seconds, not the OS connect timeout's minutes (the
    // Python client bounds this in wire.oneshot_request)
    int flags = ::fcntl(fd, F_GETFL, 0);
    ::fcntl(fd, F_SETFL, flags | O_NONBLOCK);
    int rc = ::connect(fd, ai->ai_addr, ai->ai_addrlen);
    if (rc != 0 && errno == EINPROGRESS) {
      struct pollfd pfd = {fd, POLLOUT, 0};
      int err = 0;
      socklen_t el = sizeof(err);
      if (::poll(&pfd, 1, 10000) == 1 &&
          ::getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &el) == 0 && err == 0)
        rc = 0;
    }
    if (rc == 0) {
      ::fcntl(fd, F_SETFL, flags);
      break;
    }
    ::close(fd);
    fd = -1;
  }
  freeaddrinfo(res);
  if (fd < 0) return 1;
  // bounded publish: a wedged control plane must fail the call (and
  // release the mutex), not hang every publisher thread forever
  struct timeval tv = {30, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
  g_state.fd = fd;
  g_state.subject = std::string(ns) + "." + component + ".kv_events";
  g_state.worker_id = worker_id;
  g_state.block_size = kv_block_size;
  return 0;
}

// Publish a Stored event: a chained run of full pages. token_ids holds the
// tokens of all blocks back-to-back; num_block_tokens[i] gives block i's
// token count (must equal the init kv_block_size — partial pages are never
// indexed, engine/kv_cache.py only hashes full pages); block_ids[i] is the
// worker-assigned chained hash. parent_hash is the chained hash of the
// block preceding this run, or NULL for a root run.
int dyn_kv_event_publish_stored(uint64_t event_id, const uint32_t* token_ids,
                                const size_t* num_block_tokens,
                                const uint64_t* block_ids, size_t num_blocks,
                                const uint64_t* parent_hash) {
  std::lock_guard<std::mutex> lk(g_state.mu);
  if (g_state.fd < 0) return 1;
  std::string data;
  pack_map_header(data, 3);
  pack_str(data, "kind"); pack_str(data, "stored");
  pack_str(data, "parent_hash");
  if (parent_hash) pack_uint(data, *parent_hash); else pack_nil(data);
  pack_str(data, "blocks");
  pack_array_header(data, num_blocks);
  size_t offset = 0;
  for (size_t i = 0; i < num_blocks; ++i) {
    if (num_block_tokens[i] != g_state.block_size) return 1;
    pack_array_header(data, 2);
    pack_uint(data, block_ids[i]);
    pack_uint(data, dyn_tokens_hash(token_ids + offset, num_block_tokens[i]));
    offset += num_block_tokens[i];
  }
  return publish_payload(pack_router_event(event_id, data));
}

// Publish a Removed event: chained block hashes evicted by the allocator.
int dyn_kv_event_publish_removed(uint64_t event_id,
                                 const uint64_t* block_hashes,
                                 size_t num_blocks) {
  std::lock_guard<std::mutex> lk(g_state.mu);
  if (g_state.fd < 0) return 1;
  std::string data;
  pack_map_header(data, 2);
  pack_str(data, "kind"); pack_str(data, "removed");
  pack_str(data, "block_hashes");
  pack_array_header(data, num_blocks);
  for (size_t i = 0; i < num_blocks; ++i) pack_uint(data, block_hashes[i]);
  return publish_payload(pack_router_event(event_id, data));
}

int dyn_llm_shutdown() {
  std::lock_guard<std::mutex> lk(g_state.mu);
  if (g_state.fd < 0) return 1;
  ::close(g_state.fd);
  g_state.fd = -1;
  return 0;
}

}  // extern "C"
