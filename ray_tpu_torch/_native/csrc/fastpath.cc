// ray_tpu_torch._native._fastpath — native direct-call task channel.
//
// TPU-native analog of the reference's C++ direct task transport
// (src/ray/core_worker/transport/direct_task_transport.h:75 submit side,
// src/ray/core_worker/core_worker.cc:2146 SubmitTask, and the worker-side
// PushTask handling in core_worker.proto:446): once a worker lease is held,
// eligible tasks bypass the Python asyncio/msgpack RPC stack entirely and
// ride a dedicated socket owned by this extension.
//
//   driver role: client_connect() opens a channel to a worker's fastpath
//     port. submit() frames the task and hands it to one global IO thread
//     (corked writev batching). Replies are parsed off-thread into a
//     completion list; a self-pipe byte wakes the driver's event loop,
//     which drains completions in one batch (drain()).
//   worker role: serve() runs an accept loop; each connection gets a
//     thread that reads a task frame, takes the GIL, invokes the Python
//     exec callback (function lookup + arg deserialization + user code +
//     result serialization stay in Python), and writes the reply frame.
//     Execution is serialized per connection — the same semantics as the
//     worker's sync exec thread.
//
// Frame format (little-endian):
//   [u32 frame_len] [u8 type] [u8 tid_len] [tid]
//     type 1 (task):  [u16 fid_len][fid][u16 name_len][name][args_blob]
//     type 10+status (reply): [payload]
// Completion statuses surfaced by drain(): 0 ok, 1 application error
// (payload = serialized error), 2 lost (channel died; caller resubmits
// through the normal path); the Python layers define further statuses
// (4 function-not-cached, 6 large-result-in-plasma) that ride the same
// 10+status reply encoding.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <fcntl.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

// ---------------------------------------------------------------- utils

int SetNoDelay(int fd) {
  int one = 1;
  return setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
}

void AppendU32(std::string* out, uint32_t v) {
  out->append(reinterpret_cast<const char*>(&v), 4);
}
void AppendU16(std::string* out, uint16_t v) {
  out->append(reinterpret_cast<const char*>(&v), 2);
}

bool WriteAll(int fd, const char* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::send(fd, data, len, MSG_NOSIGNAL);
    if (n < 0) {
      if (errno == EINTR) continue;
      return false;
    }
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// Buffered frame reader: large recv()s, frames parsed from the buffer —
// one syscall amortizes across many pipelined frames instead of two
// syscalls (header + body) per frame.
struct FrameReader {
  explicit FrameReader(int fd) : fd(fd) {}

  bool FillTo(size_t need) {
    while (buf.size() - pos < need) {
      char tmp[65536];
      ssize_t n = ::recv(fd, tmp, sizeof(tmp), 0);
      if (n <= 0) {
        if (n < 0 && errno == EINTR) continue;
        return false;
      }
      if (pos > (1u << 20)) {
        buf.erase(0, pos);
        pos = 0;
      }
      buf.append(tmp, static_cast<size_t>(n));
    }
    return true;
  }

  bool ReadFrame(std::string* body) {
    if (!FillTo(4)) return false;
    uint32_t len;
    std::memcpy(&len, buf.data() + pos, 4);
    if (len < 2 || len > (64u << 20)) return false;
    if (!FillTo(4 + static_cast<size_t>(len))) return false;
    body->assign(buf, pos + 4, len);
    pos += 4 + static_cast<size_t>(len);
    if (pos == buf.size()) {
      buf.clear();
      pos = 0;
    }
    return true;
  }

  // A complete frame already sits in the buffer (no syscall needed).
  bool HasBufferedFrame() const {
    if (buf.size() - pos < 4) return false;
    uint32_t len;
    std::memcpy(&len, buf.data() + pos, 4);
    return buf.size() - pos >= 4 + static_cast<size_t>(len);
  }

  int fd;
  std::string buf;
  size_t pos = 0;
};

std::string BuildTaskFrame(const std::string& tid, const std::string& fid,
                           const std::string& name, const char* args,
                           size_t args_len) {
  std::string body;
  body.reserve(1 + 1 + tid.size() + 2 + fid.size() + 2 + name.size() + args_len);
  body.push_back(static_cast<char>(1));
  body.push_back(static_cast<char>(tid.size()));
  body.append(tid);
  AppendU16(&body, static_cast<uint16_t>(fid.size()));
  body.append(fid);
  AppendU16(&body, static_cast<uint16_t>(name.size()));
  body.append(name);
  body.append(args, args_len);
  std::string frame;
  frame.reserve(4 + body.size());
  AppendU32(&frame, static_cast<uint32_t>(body.size()));
  frame.append(body);
  return frame;
}

// ---------------------------------------------------------------- driver

struct Completion {
  std::string tid;
  int status;  // 0 ok, 1 error, 2 lost
  std::string payload;
};

struct Channel {
  int id;
  int fd;
  std::thread reader;
  std::mutex mu;  // guards pending + closed
  std::unordered_set<std::string> pending;  // tids in flight
  bool closed = false;
};

class Driver {
 public:
  Driver() {
    int p[2];
    (void)!pipe(p);
    notify_rd_ = p[0];
    notify_wr_ = p[1];
    // Drain() is callable at any time (not just after a readable event):
    // an empty pipe must return 0, not block the caller.
    int flags = fcntl(notify_rd_, F_GETFL, 0);
    fcntl(notify_rd_, F_SETFL, flags | O_NONBLOCK);
  }

  int Connect(const char* host, int port) {
    int fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -1;
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
      ::close(fd);
      return -1;
    }
    if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      ::close(fd);
      return -1;
    }
    SetNoDelay(fd);
    auto ch = std::make_shared<Channel>();
    int id;
    {
      std::lock_guard<std::mutex> lk(mu_);
      id = next_id_++;
      ch->id = id;
      ch->fd = fd;
      channels_[id] = ch;
    }
    ch->reader = std::thread([this, ch] { ReadLoop(ch); });
    return id;
  }

  // Direct synchronous write from the submitting (GIL-holding Python)
  // thread. On the single-core hosts this framework targets for its
  // control plane, a dedicated IO thread only adds context switches: the
  // send() of a ~250B frame into the kernel buffer costs ~1-2us and never
  // meaningfully blocks at the pipeline depths the lease pool allows. The
  // GIL itself serializes submitters, so writes need no ordering lock.
  bool Submit(int channel_id, std::string tid, const std::string& frame) {
    std::shared_ptr<Channel> ch = Find(channel_id);
    if (!ch) return false;
    {
      std::lock_guard<std::mutex> lk(ch->mu);
      if (ch->closed) return false;
      ch->pending.insert(std::move(tid));
    }
    if (!WriteAll(ch->fd, frame.data(), frame.size())) {
      FailChannel(ch);
      return false;
    }
    return true;
  }

  void Close(int channel_id) {
    std::shared_ptr<Channel> ch;
    {
      std::lock_guard<std::mutex> lk(mu_);
      auto it = channels_.find(channel_id);
      if (it == channels_.end()) return;
      ch = it->second;
      channels_.erase(it);
    }
    ShutdownChannel(ch);
    if (ch->reader.joinable()) ch->reader.join();
  }

  std::vector<Completion> Drain() {
    // Clear the notify pipe first, then swap the list: a notifier racing in
    // after the swap re-signals, so no completion waits indefinitely.
    char buf[256];
    while (::read(notify_rd_, buf, sizeof(buf)) == sizeof(buf)) {
    }
    std::vector<Completion> out;
    {
      std::lock_guard<std::mutex> lk(done_mu_);
      out.swap(done_);
    }
    return out;
  }

  int notify_fd() const { return notify_rd_; }

  void Stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    std::vector<std::shared_ptr<Channel>> chans;
    {
      std::lock_guard<std::mutex> lk(mu_);
      for (auto& kv : channels_) chans.push_back(kv.second);
      channels_.clear();
    }
    for (auto& ch : chans) {
      ShutdownChannel(ch);
      if (ch->reader.joinable()) ch->reader.join();
    }
  }

 private:
  std::shared_ptr<Channel> Find(int id) {
    std::lock_guard<std::mutex> lk(mu_);
    auto it = channels_.find(id);
    return it == channels_.end() ? nullptr : it->second;
  }

  void ShutdownChannel(const std::shared_ptr<Channel>& ch) {
    {
      std::lock_guard<std::mutex> lk(ch->mu);
      if (ch->closed) return;
      ch->closed = true;
    }
    ::shutdown(ch->fd, SHUT_RDWR);
  }

  void Notify() {
    char b = 1;
    (void)!::write(notify_wr_, &b, 1);
  }

  void Complete(Completion c) {
    bool was_empty;
    {
      std::lock_guard<std::mutex> lk(done_mu_);
      was_empty = done_.empty();
      done_.push_back(std::move(c));
    }
    if (was_empty) Notify();
  }

  // Per-channel reply reader.
  void ReadLoop(std::shared_ptr<Channel> ch) {
    FrameReader reader(ch->fd);
    std::string body;
    for (;;) {
      if (!reader.ReadFrame(&body)) break;
      uint8_t type = static_cast<uint8_t>(body[0]);
      uint8_t tid_len = static_cast<uint8_t>(body[1]);
      if (static_cast<size_t>(2 + tid_len) > body.size()) break;
      std::string tid = body.substr(2, tid_len);
      {
        std::lock_guard<std::mutex> lk(ch->mu);
        ch->pending.erase(tid);
      }
      // Reply type is 10 + status (status 2 is reserved for channel loss,
      // reported locally by FailChannel, never by the peer).
      int status = type >= 10 ? type - 10 : 1;
      Complete({std::move(tid), status, body.substr(2 + tid_len)});
    }
    FailChannel(ch);
  }

  void FailChannel(const std::shared_ptr<Channel>& ch) {
    std::unordered_set<std::string> orphans;
    {
      std::lock_guard<std::mutex> lk(ch->mu);
      if (ch->closed && ch->pending.empty()) return;
      ch->closed = true;
      orphans.swap(ch->pending);
    }
    ::shutdown(ch->fd, SHUT_RDWR);
    for (auto& tid : orphans) Complete({tid, 2, std::string()});
  }

  std::mutex mu_;
  std::unordered_map<int, std::shared_ptr<Channel>> channels_;
  int next_id_ = 1;
  std::mutex done_mu_;
  std::vector<Completion> done_;
  int notify_rd_ = -1, notify_wr_ = -1;
  std::atomic<bool> stopping_{false};
};

Driver* g_driver = nullptr;
std::mutex g_driver_mu;

Driver* GetDriver() {
  std::lock_guard<std::mutex> lk(g_driver_mu);
  if (g_driver == nullptr) g_driver = new Driver();
  return g_driver;
}

// ---------------------------------------------------------------- server

struct Server {
  int id;
  int listen_fd;
  PyObject* callback;  // owned
  std::thread accept_thread;
  std::mutex mu;
  std::vector<std::thread> conn_threads;
  std::atomic<bool> stopping{false};
};

std::mutex g_servers_mu;
std::unordered_map<int, std::shared_ptr<Server>> g_servers;
int g_next_server_id = 1;

// Execute one parsed task frame under an already-held GIL; appends the
// reply frame to `replies`. Returns false on a malformed frame.
bool ExecOneTask(const std::shared_ptr<Server>& srv, const std::string& body,
                 std::string* replies) {
  // Every length is validated against the remaining body before it is
  // read: a truncated/corrupt frame must drop the connection, not read
  // out of bounds or throw through the thread entry.
  uint8_t type = static_cast<uint8_t>(body[0]);
  uint8_t tid_len = static_cast<uint8_t>(body[1]);
  size_t off = 2;
  if (type != 1 || off + tid_len + 2 > body.size()) return false;
  std::string tid = body.substr(off, tid_len);
  off += tid_len;
  uint16_t fid_len;
  std::memcpy(&fid_len, body.data() + off, 2);
  off += 2;
  if (off + fid_len + 2 > body.size()) return false;
  std::string fid = body.substr(off, fid_len);
  off += fid_len;
  uint16_t name_len;
  std::memcpy(&name_len, body.data() + off, 2);
  off += 2;
  if (off + name_len > body.size()) return false;
  std::string name = body.substr(off, name_len);
  off += name_len;

  int status = 1;
  std::string payload;
  PyObject* res = PyObject_CallFunction(
      srv->callback, "y#y#y#y#", tid.data(), (Py_ssize_t)tid.size(),
      fid.data(), (Py_ssize_t)fid.size(), name.data(),
      (Py_ssize_t)name.size(), body.data() + off,
      (Py_ssize_t)(body.size() - off));
  if (res != nullptr && PyTuple_Check(res) && PyTuple_GET_SIZE(res) == 2) {
    PyObject* st = PyTuple_GET_ITEM(res, 0);
    PyObject* pl = PyTuple_GET_ITEM(res, 1);
    char* data = nullptr;
    Py_ssize_t dlen = 0;
    if (PyLong_Check(st) && PyBytes_AsStringAndSize(pl, &data, &dlen) == 0) {
      status = static_cast<int>(PyLong_AsLong(st));
      payload.assign(data, static_cast<size_t>(dlen));
    }
  }
  if (res == nullptr) PyErr_Clear();
  Py_XDECREF(res);

  if (status < 0 || status > 200) status = 1;
  std::string reply_body;
  reply_body.reserve(2 + tid.size() + payload.size());
  reply_body.push_back(static_cast<char>(10 + status));
  reply_body.push_back(static_cast<char>(tid.size()));
  reply_body.append(tid);
  reply_body.append(payload);
  AppendU32(replies, static_cast<uint32_t>(reply_body.size()));
  replies->append(reply_body);
  return true;
}

void ServeConn(std::shared_ptr<Server> srv, int fd) {
  SetNoDelay(fd);
  FrameReader reader(fd);
  std::string body;
  std::string replies;
  // Adaptive corking, mirroring what the asyncio RPC path gets from its
  // transport: while more task frames are already buffered, keep executing
  // under ONE GIL hold and accumulate replies; flush with ONE send when the
  // input drains (or a batch cap hits, to bound reply latency). Per-task
  // context switches collapse to ~2 per batch.
  constexpr int kMaxBatch = 64;
  for (;;) {
    if (!reader.ReadFrame(&body)) break;
    if (srv->stopping.load() || !Py_IsInitialized()) break;
    replies.clear();
    bool ok = true;
    PyGILState_STATE gil = PyGILState_Ensure();
    int batch = 0;
    for (;;) {
      if (!ExecOneTask(srv, body, &replies)) {
        ok = false;
        break;
      }
      if (++batch >= kMaxBatch || !reader.HasBufferedFrame()) break;
      if (!reader.ReadFrame(&body)) {
        ok = false;
        break;
      }
    }
    PyGILState_Release(gil);
    if (!replies.empty() && !WriteAll(fd, replies.data(), replies.size()))
      break;
    if (!ok) break;
  }
  ::close(fd);
}

void AcceptLoop(std::shared_ptr<Server> srv) {
  for (;;) {
    int fd = ::accept(srv->listen_fd, nullptr, nullptr);
    if (fd < 0) {
      if (errno == EINTR) continue;
      break;  // listen socket closed (stop)
    }
    if (srv->stopping.load()) {
      ::close(fd);
      break;
    }
    std::lock_guard<std::mutex> lk(srv->mu);
    srv->conn_threads.emplace_back(
        [srv, fd] { ServeConn(srv, fd); });
  }
}

// ------------------------------------------------------------- wire codec
//
// C-level pack/unpack for the asyncio RPC stack's msgpack frames
// (ray_tpu_torch/_private/rpc.py). Byte-identical to
// msgpack.Packer(use_bin_type=True) / msgpack.Unpacker(raw=False,
// strict_map_key=False): the Python side fuzzes parity in both directions
// (tests/test_fastpath_native.py), so any divergence is a test failure,
// not a silent wire fork. Registered per-schema: rpc.py consults
// schema_versions() against wire.NATIVE_WIRE_SCHEMAS and only routes a
// method here while the versions match.
//
// The schema markers below are parsed by devtools/rpc_check.py
// (wire-native-drift): editing a natively-packed schema's field list in
// wire.py without bumping BOTH the version there and the marker (and
// table) here fails lint.
//
// NATIVE_WIRE_SCHEMA: RequestWorkerLease v1 fields=bundle_index,job_id,lease_id,locality,pg_id,resources,spilled_from,strategy
// NATIVE_WIRE_SCHEMA: ReturnWorker v1 fields=dirty,lease_id
// NATIVE_WIRE_SCHEMA: CancelWorkerLease v1 fields=lease_id
// NATIVE_WIRE_SCHEMA: LeaseBatch v1 fields=entries
// NATIVE_WIRE_SCHEMA: PubBatch v1 fields=items

struct WireSchema {
  const char* method;
  int version;
};
constexpr WireSchema kWireSchemas[] = {
    {"RequestWorkerLease", 1}, {"ReturnWorker", 1}, {"CancelWorkerLease", 1},
    {"LeaseBatch", 1},         {"PubBatch", 1},
};

constexpr size_t kMaxWireFrame = 64u << 20;  // mirrors rpc._MAX_FRAME

// -- encoder --

void PutBE16(std::string* out, uint16_t v) {
  char b[2] = {static_cast<char>(v >> 8), static_cast<char>(v)};
  out->append(b, 2);
}
void PutBE32(std::string* out, uint32_t v) {
  char b[4] = {static_cast<char>(v >> 24), static_cast<char>(v >> 16),
               static_cast<char>(v >> 8), static_cast<char>(v)};
  out->append(b, 4);
}
void PutBE64(std::string* out, uint64_t v) {
  char b[8];
  for (int i = 0; i < 8; ++i) b[i] = static_cast<char>(v >> (56 - 8 * i));
  out->append(b, 8);
}

// Packs one Python object; byte-for-byte what msgpack-python's C packer
// emits for the same value. Returns false with a Python error set on
// unsupported types (caller falls back to the Python packer).
bool PackObj(std::string* out, PyObject* o, int depth) {
  if (depth > 128) {
    PyErr_SetString(PyExc_ValueError, "pack_frame: nesting too deep");
    return false;
  }
  if (o == Py_None) {
    out->push_back(static_cast<char>(0xc0));
    return true;
  }
  // bool before int: Python bool subclasses int.
  if (PyBool_Check(o)) {
    out->push_back(static_cast<char>(o == Py_True ? 0xc3 : 0xc2));
    return true;
  }
  if (PyLong_Check(o)) {
    int overflow = 0;
    long long v = PyLong_AsLongLongAndOverflow(o, &overflow);
    if (overflow > 0) {
      unsigned long long u = PyLong_AsUnsignedLongLong(o);
      if (u == static_cast<unsigned long long>(-1) && PyErr_Occurred())
        return false;  // > 2**64-1: OverflowError, like msgpack
      out->push_back(static_cast<char>(0xcf));
      PutBE64(out, u);
      return true;
    }
    if (overflow < 0) {
      PyErr_SetString(PyExc_OverflowError, "int too small for msgpack");
      return false;
    }
    if (v == -1 && PyErr_Occurred()) return false;
    if (v >= 0) {
      if (v < 0x80) {
        out->push_back(static_cast<char>(v));
      } else if (v < 0x100) {
        out->push_back(static_cast<char>(0xcc));
        out->push_back(static_cast<char>(v));
      } else if (v < 0x10000) {
        out->push_back(static_cast<char>(0xcd));
        PutBE16(out, static_cast<uint16_t>(v));
      } else if (v < 0x100000000LL) {
        out->push_back(static_cast<char>(0xce));
        PutBE32(out, static_cast<uint32_t>(v));
      } else {
        out->push_back(static_cast<char>(0xcf));
        PutBE64(out, static_cast<uint64_t>(v));
      }
    } else {
      if (v >= -32) {
        out->push_back(static_cast<char>(0xe0 | (v & 0x1f)));
      } else if (v >= -128) {
        out->push_back(static_cast<char>(0xd0));
        out->push_back(static_cast<char>(v));
      } else if (v >= -32768) {
        out->push_back(static_cast<char>(0xd1));
        PutBE16(out, static_cast<uint16_t>(v));
      } else if (v >= -2147483648LL) {
        out->push_back(static_cast<char>(0xd2));
        PutBE32(out, static_cast<uint32_t>(v));
      } else {
        out->push_back(static_cast<char>(0xd3));
        PutBE64(out, static_cast<uint64_t>(v));
      }
    }
    return true;
  }
  if (PyFloat_Check(o)) {
    double d = PyFloat_AS_DOUBLE(o);
    uint64_t bits;
    std::memcpy(&bits, &d, 8);
    out->push_back(static_cast<char>(0xcb));
    PutBE64(out, bits);
    return true;
  }
  if (PyUnicode_Check(o)) {
    Py_ssize_t len;
    const char* s = PyUnicode_AsUTF8AndSize(o, &len);
    if (s == nullptr) return false;
    size_t n = static_cast<size_t>(len);
    if (n < 32) {
      out->push_back(static_cast<char>(0xa0 | n));
    } else if (n < 0x100) {
      out->push_back(static_cast<char>(0xd9));
      out->push_back(static_cast<char>(n));
    } else if (n < 0x10000) {
      out->push_back(static_cast<char>(0xda));
      PutBE16(out, static_cast<uint16_t>(n));
    } else {
      out->push_back(static_cast<char>(0xdb));
      PutBE32(out, static_cast<uint32_t>(n));
    }
    out->append(s, n);
    return true;
  }
  if (PyBytes_Check(o) || PyByteArray_Check(o) || PyMemoryView_Check(o)) {
    Py_buffer view;
    if (PyObject_GetBuffer(o, &view, PyBUF_CONTIG_RO) != 0) return false;
    size_t n = static_cast<size_t>(view.len);
    if (n < 0x100) {
      out->push_back(static_cast<char>(0xc4));
      out->push_back(static_cast<char>(n));
    } else if (n < 0x10000) {
      out->push_back(static_cast<char>(0xc5));
      PutBE16(out, static_cast<uint16_t>(n));
    } else {
      out->push_back(static_cast<char>(0xc6));
      PutBE32(out, static_cast<uint32_t>(n));
    }
    out->append(static_cast<const char*>(view.buf), n);
    PyBuffer_Release(&view);
    return true;
  }
  if (PyList_Check(o) || PyTuple_Check(o)) {
    Py_ssize_t n = PySequence_Fast_GET_SIZE(o);
    if (n < 16) {
      out->push_back(static_cast<char>(0x90 | n));
    } else if (n < 0x10000) {
      out->push_back(static_cast<char>(0xdc));
      PutBE16(out, static_cast<uint16_t>(n));
    } else {
      out->push_back(static_cast<char>(0xdd));
      PutBE32(out, static_cast<uint32_t>(n));
    }
    for (Py_ssize_t i = 0; i < n; ++i) {
      PyObject* item = PyList_Check(o) ? PyList_GET_ITEM(o, i)
                                       : PyTuple_GET_ITEM(o, i);
      if (!PackObj(out, item, depth + 1)) return false;
    }
    return true;
  }
  if (PyDict_Check(o)) {
    Py_ssize_t n = PyDict_Size(o);
    if (n < 16) {
      out->push_back(static_cast<char>(0x80 | n));
    } else if (n < 0x10000) {
      out->push_back(static_cast<char>(0xde));
      PutBE16(out, static_cast<uint16_t>(n));
    } else {
      out->push_back(static_cast<char>(0xdf));
      PutBE32(out, static_cast<uint32_t>(n));
    }
    PyObject *key, *value;
    Py_ssize_t pos = 0;
    while (PyDict_Next(o, &pos, &key, &value)) {
      if (!PackObj(out, key, depth + 1)) return false;
      if (!PackObj(out, value, depth + 1)) return false;
    }
    return true;
  }
  PyErr_Format(PyExc_TypeError, "pack_frame: cannot pack %s",
               Py_TYPE(o)->tp_name);
  return false;
}

// -- decoder --

enum ParseStatus { kParseOk = 0, kParseMore = 1, kParseErr = 2 };

uint32_t GetBE32(const unsigned char* p) {
  return (static_cast<uint32_t>(p[0]) << 24) |
         (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// Parses one msgpack object at *off. On kParseOk advances *off and sets
// *out (new reference). kParseMore = need more bytes (*off untouched,
// no error set). kParseErr = malformed stream (Python error set).
ParseStatus ParseObj(const unsigned char* p, size_t n, size_t* off,
                     PyObject** out, int depth) {
  if (depth > 128) {
    PyErr_SetString(PyExc_ValueError, "msgpack nesting too deep");
    return kParseErr;
  }
  size_t o = *off;
  if (o >= n) return kParseMore;
  uint8_t b = p[o++];
  // Fast scalar forms first.
  if (b < 0x80) {  // positive fixint
    *out = PyLong_FromLong(b);
    *off = o;
    return *out ? kParseOk : kParseErr;
  }
  if (b >= 0xe0) {  // negative fixint
    *out = PyLong_FromLong(static_cast<int8_t>(b));
    *off = o;
    return *out ? kParseOk : kParseErr;
  }
  size_t len = 0;
  switch (b) {
    case 0xc0:
      Py_INCREF(Py_None);
      *out = Py_None;
      *off = o;
      return kParseOk;
    case 0xc2:
      Py_INCREF(Py_False);
      *out = Py_False;
      *off = o;
      return kParseOk;
    case 0xc3:
      Py_INCREF(Py_True);
      *out = Py_True;
      *off = o;
      return kParseOk;
    case 0xcc:
      if (o + 1 > n) return kParseMore;
      *out = PyLong_FromLong(p[o]);
      *off = o + 1;
      return *out ? kParseOk : kParseErr;
    case 0xcd:
      if (o + 2 > n) return kParseMore;
      *out = PyLong_FromLong((p[o] << 8) | p[o + 1]);
      *off = o + 2;
      return *out ? kParseOk : kParseErr;
    case 0xce:
      if (o + 4 > n) return kParseMore;
      *out = PyLong_FromUnsignedLong(GetBE32(p + o));
      *off = o + 4;
      return *out ? kParseOk : kParseErr;
    case 0xcf: {
      if (o + 8 > n) return kParseMore;
      uint64_t v = (static_cast<uint64_t>(GetBE32(p + o)) << 32) |
                   GetBE32(p + o + 4);
      *out = PyLong_FromUnsignedLongLong(v);
      *off = o + 8;
      return *out ? kParseOk : kParseErr;
    }
    case 0xd0:
      if (o + 1 > n) return kParseMore;
      *out = PyLong_FromLong(static_cast<int8_t>(p[o]));
      *off = o + 1;
      return *out ? kParseOk : kParseErr;
    case 0xd1:
      if (o + 2 > n) return kParseMore;
      *out = PyLong_FromLong(
          static_cast<int16_t>((p[o] << 8) | p[o + 1]));
      *off = o + 2;
      return *out ? kParseOk : kParseErr;
    case 0xd2:
      if (o + 4 > n) return kParseMore;
      *out = PyLong_FromLong(static_cast<int32_t>(GetBE32(p + o)));
      *off = o + 4;
      return *out ? kParseOk : kParseErr;
    case 0xd3: {
      if (o + 8 > n) return kParseMore;
      uint64_t v = (static_cast<uint64_t>(GetBE32(p + o)) << 32) |
                   GetBE32(p + o + 4);
      *out = PyLong_FromLongLong(static_cast<int64_t>(v));
      *off = o + 8;
      return *out ? kParseOk : kParseErr;
    }
    case 0xca: {  // float32 (never emitted by us; accepted for parity)
      if (o + 4 > n) return kParseMore;
      uint32_t bits = GetBE32(p + o);
      float f;
      std::memcpy(&f, &bits, 4);
      *out = PyFloat_FromDouble(f);
      *off = o + 4;
      return *out ? kParseOk : kParseErr;
    }
    case 0xcb: {
      if (o + 8 > n) return kParseMore;
      uint64_t bits = (static_cast<uint64_t>(GetBE32(p + o)) << 32) |
                      GetBE32(p + o + 4);
      double d;
      std::memcpy(&d, &bits, 8);
      *out = PyFloat_FromDouble(d);
      *off = o + 8;
      return *out ? kParseOk : kParseErr;
    }
    case 0xd9:  // str8
      if (o + 1 > n) return kParseMore;
      len = p[o];
      o += 1;
      goto parse_str;
    case 0xda:
      if (o + 2 > n) return kParseMore;
      len = (p[o] << 8) | p[o + 1];
      o += 2;
      goto parse_str;
    case 0xdb:
      if (o + 4 > n) return kParseMore;
      len = GetBE32(p + o);
      o += 4;
      goto parse_str;
    case 0xc4:
      if (o + 1 > n) return kParseMore;
      len = p[o];
      o += 1;
      goto parse_bin;
    case 0xc5:
      if (o + 2 > n) return kParseMore;
      len = (p[o] << 8) | p[o + 1];
      o += 2;
      goto parse_bin;
    case 0xc6:
      if (o + 4 > n) return kParseMore;
      len = GetBE32(p + o);
      o += 4;
      goto parse_bin;
    case 0xdc:
      if (o + 2 > n) return kParseMore;
      len = (p[o] << 8) | p[o + 1];
      o += 2;
      goto parse_array;
    case 0xdd:
      if (o + 4 > n) return kParseMore;
      len = GetBE32(p + o);
      o += 4;
      goto parse_array;
    case 0xde:
      if (o + 2 > n) return kParseMore;
      len = (p[o] << 8) | p[o + 1];
      o += 2;
      goto parse_map;
    case 0xdf:
      if (o + 4 > n) return kParseMore;
      len = GetBE32(p + o);
      o += 4;
      goto parse_map;
    default:
      if ((b & 0xe0) == 0xa0) {  // fixstr
        len = b & 0x1f;
        goto parse_str;
      }
      if ((b & 0xf0) == 0x90) {  // fixarray
        len = b & 0x0f;
        goto parse_array;
      }
      if ((b & 0xf0) == 0x80) {  // fixmap
        len = b & 0x0f;
        goto parse_map;
      }
      // 0xc1 (reserved) and ext families: the wire never carries them.
      PyErr_Format(PyExc_ValueError, "unsupported msgpack byte 0x%02x", b);
      return kParseErr;
  }

parse_str:
  if (len > kMaxWireFrame) {
    PyErr_SetString(PyExc_ValueError, "msgpack str too large");
    return kParseErr;
  }
  if (o + len > n) return kParseMore;
  *out = PyUnicode_DecodeUTF8(reinterpret_cast<const char*>(p + o),
                              static_cast<Py_ssize_t>(len), nullptr);
  if (*out == nullptr) return kParseErr;
  *off = o + len;
  return kParseOk;

parse_bin:
  if (len > kMaxWireFrame) {
    PyErr_SetString(PyExc_ValueError, "msgpack bin too large");
    return kParseErr;
  }
  if (o + len > n) return kParseMore;
  *out = PyBytes_FromStringAndSize(reinterpret_cast<const char*>(p + o),
                                   static_cast<Py_ssize_t>(len));
  if (*out == nullptr) return kParseErr;
  *off = o + len;
  return kParseOk;

parse_array: {
  if (len > (16u << 20)) {
    PyErr_SetString(PyExc_ValueError, "msgpack array too large");
    return kParseErr;
  }
  PyObject* list = PyList_New(static_cast<Py_ssize_t>(len));
  if (list == nullptr) return kParseErr;
  for (size_t i = 0; i < len; ++i) {
    PyObject* item = nullptr;
    ParseStatus st = ParseObj(p, n, &o, &item, depth + 1);
    if (st != kParseOk) {
      Py_DECREF(list);
      return st;
    }
    PyList_SET_ITEM(list, static_cast<Py_ssize_t>(i), item);  // steals
  }
  *out = list;
  *off = o;
  return kParseOk;
}

parse_map: {
  if (len > (16u << 20)) {
    PyErr_SetString(PyExc_ValueError, "msgpack map too large");
    return kParseErr;
  }
  PyObject* dict = PyDict_New();
  if (dict == nullptr) return kParseErr;
  for (size_t i = 0; i < len; ++i) {
    PyObject* key = nullptr;
    PyObject* value = nullptr;
    ParseStatus st = ParseObj(p, n, &o, &key, depth + 1);
    if (st != kParseOk) {
      Py_DECREF(dict);
      return st;
    }
    st = ParseObj(p, n, &o, &value, depth + 1);
    if (st != kParseOk) {
      Py_DECREF(key);
      Py_DECREF(dict);
      return st;
    }
    int rc = PyDict_SetItem(dict, key, value);
    Py_DECREF(key);
    Py_DECREF(value);
    if (rc != 0) {  // e.g. unhashable key
      Py_DECREF(dict);
      return kParseErr;
    }
  }
  *out = dict;
  *off = o;
  return kParseOk;
}
}

// Streaming decoder object: the same feed()/iterate/tell() surface as
// msgpack.Unpacker, so rpc._new_unpacker can swap it in transparently
// (including the blob-mode switch, which relies on tell() counting total
// consumed bytes since construction).
struct DecoderObject {
  PyObject_HEAD
  std::string* buf;
  size_t pos;                      // parse cursor into *buf
  unsigned long long consumed;     // total bytes consumed since creation
};

PyObject* DecoderNew(PyTypeObject* type, PyObject*, PyObject*) {
  DecoderObject* self =
      reinterpret_cast<DecoderObject*>(type->tp_alloc(type, 0));
  if (self == nullptr) return nullptr;
  self->buf = new std::string();
  self->pos = 0;
  self->consumed = 0;
  return reinterpret_cast<PyObject*>(self);
}

void DecoderDealloc(DecoderObject* self) {
  delete self->buf;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

PyObject* DecoderFeed(DecoderObject* self, PyObject* arg) {
  Py_buffer view;
  if (PyObject_GetBuffer(arg, &view, PyBUF_CONTIG_RO) != 0) return nullptr;
  if (self->buf->size() - self->pos + static_cast<size_t>(view.len) >
      kMaxWireFrame) {
    PyBuffer_Release(&view);
    PyErr_SetString(PyExc_ValueError, "decoder buffer limit exceeded");
    return nullptr;
  }
  // Compact consumed prefix before it grows unbounded.
  if (self->pos > (1u << 20)) {
    self->buf->erase(0, self->pos);
    self->pos = 0;
  }
  self->buf->append(static_cast<const char*>(view.buf),
                    static_cast<size_t>(view.len));
  PyBuffer_Release(&view);
  Py_RETURN_NONE;
}

PyObject* DecoderTell(DecoderObject* self, PyObject*) {
  return PyLong_FromUnsignedLongLong(self->consumed);
}

PyObject* DecoderIter(PyObject* self) {
  Py_INCREF(self);
  return self;
}

PyObject* DecoderNext(DecoderObject* self) {
  const unsigned char* p =
      reinterpret_cast<const unsigned char*>(self->buf->data());
  size_t n = self->buf->size();
  size_t off = self->pos;
  PyObject* out = nullptr;
  ParseStatus st = ParseObj(p, n, &off, &out, 0);
  if (st == kParseOk) {
    self->consumed += off - self->pos;
    self->pos = off;
    return out;
  }
  if (st == kParseMore) return nullptr;  // StopIteration (no error set)
  return nullptr;                        // kParseErr: Python error already set
}

PyMethodDef kDecoderMethods[] = {
    {"feed", reinterpret_cast<PyCFunction>(DecoderFeed), METH_O,
     "feed(bytes-like): append raw stream bytes"},
    {"tell", reinterpret_cast<PyCFunction>(DecoderTell), METH_NOARGS,
     "tell() -> total bytes consumed since creation"},
    {nullptr, nullptr, 0, nullptr},
};

PyTypeObject DecoderType = {
    PyVarObject_HEAD_INIT(nullptr, 0) "_fastpath.Decoder", /* tp_name */
    sizeof(DecoderObject),                                 /* tp_basicsize */
    0,                                                     /* tp_itemsize */
    reinterpret_cast<destructor>(DecoderDealloc),          /* tp_dealloc */
};

PyObject* py_pack_frame(PyObject*, PyObject* arg) {
  std::string out;
  out.reserve(256);
  if (!PackObj(&out, arg, 0)) return nullptr;
  return PyBytes_FromStringAndSize(out.data(),
                                   static_cast<Py_ssize_t>(out.size()));
}

PyObject* py_schema_versions(PyObject*, PyObject*) {
  PyObject* d = PyDict_New();
  if (d == nullptr) return nullptr;
  for (const auto& s : kWireSchemas) {
    PyObject* v = PyLong_FromLong(s.version);
    if (v == nullptr || PyDict_SetItemString(d, s.method, v) != 0) {
      Py_XDECREF(v);
      Py_DECREF(d);
      return nullptr;
    }
    Py_DECREF(v);
  }
  return d;
}

// ---------------------------------------------------------------- python

PyObject* py_client_connect(PyObject*, PyObject* args) {
  const char* host;
  int port;
  if (!PyArg_ParseTuple(args, "si", &host, &port)) return nullptr;
  int id;
  Py_BEGIN_ALLOW_THREADS;
  id = GetDriver()->Connect(host, port);
  Py_END_ALLOW_THREADS;
  return PyLong_FromLong(id);
}

PyObject* py_client_close(PyObject*, PyObject* args) {
  int id;
  if (!PyArg_ParseTuple(args, "i", &id)) return nullptr;
  Py_BEGIN_ALLOW_THREADS;
  GetDriver()->Close(id);
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

PyObject* py_submit(PyObject*, PyObject* args) {
  int id;
  const char *tid, *fid, *name, *blob;
  Py_ssize_t tid_len, fid_len, name_len, blob_len;
  if (!PyArg_ParseTuple(args, "iy#y#y#y#", &id, &tid, &tid_len, &fid,
                        &fid_len, &name, &name_len, &blob, &blob_len))
    return nullptr;
  if (tid_len > 255 || fid_len > 65535 || name_len > 65535) {
    PyErr_SetString(PyExc_ValueError, "fastpath field too long");
    return nullptr;
  }
  std::string t(tid, tid_len);
  std::string frame = BuildTaskFrame(
      t, std::string(fid, fid_len), std::string(name, name_len), blob,
      static_cast<size_t>(blob_len));
  // No ALLOW_THREADS: the critical sections inside Submit are O(1) swaps
  // and a condvar notify — releasing the GIL for that costs more (a
  // contended re-acquire) than it saves.
  bool ok = GetDriver()->Submit(id, std::move(t), std::move(frame));
  if (ok) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

PyObject* py_notify_fd(PyObject*, PyObject*) {
  return PyLong_FromLong(GetDriver()->notify_fd());
}

PyObject* py_drain(PyObject*, PyObject*) {
  std::vector<Completion> done;
  Py_BEGIN_ALLOW_THREADS;
  done = GetDriver()->Drain();
  Py_END_ALLOW_THREADS;
  PyObject* out = PyList_New(static_cast<Py_ssize_t>(done.size()));
  if (out == nullptr) return nullptr;
  for (size_t i = 0; i < done.size(); ++i) {
    PyObject* item = Py_BuildValue(
        "(y#iy#)", done[i].tid.data(), (Py_ssize_t)done[i].tid.size(),
        done[i].status, done[i].payload.data(),
        (Py_ssize_t)done[i].payload.size());
    if (item == nullptr) {
      Py_DECREF(out);
      return nullptr;
    }
    PyList_SET_ITEM(out, static_cast<Py_ssize_t>(i), item);
  }
  return out;
}

PyObject* py_serve(PyObject*, PyObject* args) {
  const char* host;
  int port;
  PyObject* callback;
  if (!PyArg_ParseTuple(args, "siO", &host, &port, &callback)) return nullptr;
  if (!PyCallable_Check(callback)) {
    PyErr_SetString(PyExc_TypeError, "callback must be callable");
    return nullptr;
  }
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) {
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0 ||
      ::listen(fd, 64) != 0) {
    ::close(fd);
    PyErr_SetFromErrno(PyExc_OSError);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  int bound_port = ntohs(addr.sin_port);

  auto srv = std::make_shared<Server>();
  srv->listen_fd = fd;
  Py_INCREF(callback);
  srv->callback = callback;
  int id;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    id = g_next_server_id++;
    srv->id = id;
    g_servers[id] = srv;
  }
  srv->accept_thread = std::thread([srv] { AcceptLoop(srv); });
  return Py_BuildValue("(ii)", id, bound_port);
}

PyObject* py_stop_server(PyObject*, PyObject* args) {
  int id;
  if (!PyArg_ParseTuple(args, "i", &id)) return nullptr;
  std::shared_ptr<Server> srv;
  {
    std::lock_guard<std::mutex> lk(g_servers_mu);
    auto it = g_servers.find(id);
    if (it != g_servers.end()) {
      srv = it->second;
      g_servers.erase(it);
    }
  }
  if (srv) {
    srv->stopping.store(true);
    ::shutdown(srv->listen_fd, SHUT_RDWR);
    ::close(srv->listen_fd);
    Py_BEGIN_ALLOW_THREADS;
    if (srv->accept_thread.joinable()) srv->accept_thread.join();
    {
      std::lock_guard<std::mutex> lk(srv->mu);
      for (auto& t : srv->conn_threads)
        if (t.joinable()) t.detach();  // blocked in recv; sockets closed by
                                       // peers at teardown
    }
    Py_END_ALLOW_THREADS;
  }
  Py_RETURN_NONE;
}

PyObject* py_stop_all(PyObject*, PyObject*) {
  Driver* d = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_driver_mu);
    d = g_driver;
  }
  if (d != nullptr) {
    Py_BEGIN_ALLOW_THREADS;
    d->Stop();
    Py_END_ALLOW_THREADS;
  }
  Py_RETURN_NONE;
}

PyMethodDef kMethods[] = {
    {"client_connect", py_client_connect, METH_VARARGS,
     "client_connect(host, port) -> channel_id (-1 on failure)"},
    {"client_close", py_client_close, METH_VARARGS, "close a channel"},
    {"submit", py_submit, METH_VARARGS,
     "submit(channel_id, task_id, func_id, name, args_blob) -> bool"},
    {"notify_fd", py_notify_fd, METH_NOARGS,
     "fd readable when completions are pending"},
    {"drain", py_drain, METH_NOARGS,
     "drain() -> [(task_id, status, payload)]"},
    {"serve", py_serve, METH_VARARGS,
     "serve(host, port, callback) -> (server_id, bound_port)"},
    {"stop_server", py_stop_server, METH_VARARGS, "stop a server"},
    {"stop_all", py_stop_all, METH_NOARGS, "stop the driver IO threads"},
    {"pack_frame", py_pack_frame, METH_O,
     "pack_frame(obj) -> bytes (msgpack, byte-identical to the Python "
     "packer)"},
    {"schema_versions", py_schema_versions, METH_NOARGS,
     "schema_versions() -> {method: version} for natively packed schemas"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef kModule = {
    PyModuleDef_HEAD_INIT, "_fastpath",
    "native direct-call task channel (driver + worker roles)", -1, kMethods,
};

}  // namespace

PyMODINIT_FUNC PyInit__fastpath() {
  DecoderType.tp_flags = Py_TPFLAGS_DEFAULT;
  DecoderType.tp_doc = "streaming msgpack decoder (msgpack.Unpacker surface)";
  DecoderType.tp_iter = DecoderIter;
  DecoderType.tp_iternext = reinterpret_cast<iternextfunc>(DecoderNext);
  DecoderType.tp_methods = kDecoderMethods;
  DecoderType.tp_new = DecoderNew;
  if (PyType_Ready(&DecoderType) < 0) return nullptr;
  PyObject* mod = PyModule_Create(&kModule);
  if (mod == nullptr) return nullptr;
  Py_INCREF(&DecoderType);
  if (PyModule_AddObject(mod, "Decoder",
                         reinterpret_cast<PyObject*>(&DecoderType)) < 0) {
    Py_DECREF(&DecoderType);
    Py_DECREF(mod);
    return nullptr;
  }
  return mod;
}
