// ray_tpu_torch._native._store — plasma-style object-store core: best-fit arena
// allocator with coalescing free lists, object table, and LRU eviction.
//
// TPU-native analog of the reference's plasma store internals
// (src/ray/object_manager/plasma/{plasma_allocator.cc,object_lifecycle_manager.cc,
// eviction_policy.cc}): the reference subdivides one big mmap with dlmalloc and
// tracks object lifecycle + LRU eviction in the store process. Here the same
// three concerns live in this extension, owned by the raylet: the arena
// itself is a single POSIX shm segment (mapped via ray_tpu_torch._native._shm);
// this module only does the bookkeeping — allocation offsets, seal/pin
// state, LRU ordering — so the Python fallback can implement the identical
// interface.
//
// Exposed API (class StoreCore):
//   StoreCore(capacity)
//   alloc(oid, size, pin) -> offset            (-1 if it doesn't fit)
//   seal(oid) / is_sealed(oid)
//   touch(oid)                                  (LRU bump, on every access)
//   pin(oid) / unpin(oid)
//   free(oid) -> size                           (0 if absent)
//   evict(nbytes, grace_ticks) -> [oid, ...]    (frees sealed+unpinned LRU
//                                                victims not touched within
//                                                the last grace_ticks touches)
//   lookup(oid) -> (offset, size, sealed, pinned) | None
//   used / capacity / num_objects / fragmentation()

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <map>
#include <set>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ObjEntry {
  uint64_t offset = 0;
  uint64_t size = 0;
  bool sealed = false;
  bool pinned = false;
  uint64_t lru_tick = 0;
};

// Best-fit allocator over [0, capacity) with O(log n) alloc/free and
// neighbor coalescing. Two indexes over the same free spans:
//   by_offset: offset -> size      (coalescing)
//   by_size:   (size, offset)      (best-fit lookup)
class Allocator {
 public:
  explicit Allocator(uint64_t capacity) : capacity_(capacity) {
    by_offset_[0] = capacity;
    by_size_.insert({capacity, 0});
  }

  static uint64_t Round(uint64_t size) {
    // Round to 64B so neighboring objects never share a cache line.
    if (size == 0) size = 1;
    return (size + 63) & ~uint64_t(63);
  }

  int64_t Alloc(uint64_t size) {
    size = Round(size);
    auto it = by_size_.lower_bound({size, 0});
    if (it == by_size_.end()) return -1;
    uint64_t span_size = it->first, span_off = it->second;
    by_size_.erase(it);
    by_offset_.erase(span_off);
    if (span_size > size) {
      uint64_t rest_off = span_off + size;
      uint64_t rest_size = span_size - size;
      by_offset_[rest_off] = rest_size;
      by_size_.insert({rest_size, rest_off});
    }
    return static_cast<int64_t>(span_off);
  }

  void Free(uint64_t offset, uint64_t size) {
    size = Round(size);
    // Coalesce with successor.
    auto next = by_offset_.lower_bound(offset);
    if (next != by_offset_.end() && next->first == offset + size) {
      size += next->second;
      by_size_.erase({next->second, next->first});
      by_offset_.erase(next);
    }
    // Coalesce with predecessor.
    auto prev = by_offset_.lower_bound(offset);
    if (prev != by_offset_.begin()) {
      --prev;
      if (prev->first + prev->second == offset) {
        by_size_.erase({prev->second, prev->first});
        offset = prev->first;
        size += prev->second;
        by_offset_.erase(prev);
      }
    }
    by_offset_[offset] = size;
    by_size_.insert({size, offset});
  }

  uint64_t LargestFree() const {
    return by_size_.empty() ? 0 : by_size_.rbegin()->first;
  }

  size_t NumSpans() const { return by_offset_.size(); }

 private:
  uint64_t capacity_;
  std::map<uint64_t, uint64_t> by_offset_;      // offset -> size (free spans)
  std::set<std::pair<uint64_t, uint64_t>> by_size_;  // (size, offset)
};

struct StoreCoreObject {
  PyObject_HEAD
  Allocator* alloc;
  std::unordered_map<std::string, ObjEntry>* objects;
  std::map<uint64_t, std::string>* lru;  // tick -> oid
  uint64_t capacity;
  uint64_t used;
  uint64_t tick;
};

static void StoreCore_dealloc(StoreCoreObject* self) {
  delete self->alloc;
  delete self->objects;
  delete self->lru;
  Py_TYPE(self)->tp_free(reinterpret_cast<PyObject*>(self));
}

static PyObject* StoreCore_new(PyTypeObject* type, PyObject* args, PyObject* kwds) {
  StoreCoreObject* self =
      reinterpret_cast<StoreCoreObject*>(type->tp_alloc(type, 0));
  if (self != nullptr) {
    self->alloc = nullptr;
    self->objects = nullptr;
    self->lru = nullptr;
    self->capacity = 0;
    self->used = 0;
    self->tick = 0;
  }
  return reinterpret_cast<PyObject*>(self);
}

static int StoreCore_init(StoreCoreObject* self, PyObject* args, PyObject* kwds) {
  static const char* kwlist[] = {"capacity", nullptr};
  unsigned long long capacity = 0;
  if (!PyArg_ParseTupleAndKeywords(args, kwds, "K",
                                   const_cast<char**>(kwlist), &capacity)) {
    return -1;
  }
  self->capacity = capacity;
  self->alloc = new Allocator(capacity);
  self->objects = new std::unordered_map<std::string, ObjEntry>();
  self->lru = new std::map<uint64_t, std::string>();
  return 0;
}

static ObjEntry* FindEntry(StoreCoreObject* self, const char* oid) {
  auto it = self->objects->find(oid);
  return it == self->objects->end() ? nullptr : &it->second;
}

// lru maps tick -> oid, so touching needs the oid string.
static void TouchEntryNamed(StoreCoreObject* self, const std::string& oid,
                            ObjEntry* e) {
  self->lru->erase(e->lru_tick);
  e->lru_tick = ++self->tick;
  (*self->lru)[e->lru_tick] = oid;
}

static PyObject* StoreCore_alloc(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  unsigned long long size;
  int pin = 1;
  if (!PyArg_ParseTuple(args, "sK|p", &oid, &size, &pin)) return nullptr;
  if (FindEntry(self, oid) != nullptr) {
    PyErr_Format(PyExc_KeyError, "object %s already allocated", oid);
    return nullptr;
  }
  int64_t off = self->alloc->Alloc(size);
  if (off < 0) return PyLong_FromLong(-1);
  ObjEntry e;
  e.offset = static_cast<uint64_t>(off);
  e.size = size;
  e.pinned = pin != 0;
  (*self->objects)[oid] = e;
  TouchEntryNamed(self, oid, &(*self->objects)[oid]);
  self->used += size;
  return PyLong_FromLongLong(off);
}

static PyObject* StoreCore_seal(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  ObjEntry* e = FindEntry(self, oid);
  if (e == nullptr) {
    PyErr_Format(PyExc_KeyError, "unknown object %s", oid);
    return nullptr;
  }
  e->sealed = true;
  TouchEntryNamed(self, oid, e);
  Py_RETURN_NONE;
}

static PyObject* StoreCore_touch(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  ObjEntry* e = FindEntry(self, oid);
  if (e != nullptr) TouchEntryNamed(self, oid, e);
  Py_RETURN_NONE;
}

static PyObject* SetPin(StoreCoreObject* self, PyObject* args, bool pinned) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  ObjEntry* e = FindEntry(self, oid);
  if (e != nullptr) e->pinned = pinned;
  Py_RETURN_NONE;
}

static PyObject* StoreCore_pin(StoreCoreObject* self, PyObject* args) {
  return SetPin(self, args, true);
}

static PyObject* StoreCore_unpin(StoreCoreObject* self, PyObject* args) {
  return SetPin(self, args, false);
}

static PyObject* StoreCore_free(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  auto it = self->objects->find(oid);
  if (it == self->objects->end()) return PyLong_FromLong(0);
  ObjEntry& e = it->second;
  self->alloc->Free(e.offset, e.size);
  self->used -= e.size;
  self->lru->erase(e.lru_tick);
  uint64_t size = e.size;
  self->objects->erase(it);
  return PyLong_FromUnsignedLongLong(size);
}

static PyObject* StoreCore_evict(StoreCoreObject* self, PyObject* args) {
  unsigned long long nbytes;
  unsigned long long grace_ticks = 0;
  if (!PyArg_ParseTuple(args, "K|K", &nbytes, &grace_ticks)) return nullptr;
  PyObject* out = PyList_New(0);
  if (out == nullptr) return nullptr;
  uint64_t freed = 0;
  uint64_t min_tick_protected =
      grace_ticks >= self->tick ? 0 : self->tick - grace_ticks;
  auto it = self->lru->begin();
  while (it != self->lru->end() && freed < nbytes) {
    if (grace_ticks > 0 && it->first > min_tick_protected) break;
    const std::string oid = it->second;
    auto oit = self->objects->find(oid);
    if (oit == self->objects->end()) {
      it = self->lru->erase(it);
      continue;
    }
    ObjEntry& e = oit->second;
    if (!e.sealed || e.pinned) {
      ++it;
      continue;
    }
    self->alloc->Free(e.offset, e.size);
    self->used -= e.size;
    freed += e.size;
    it = self->lru->erase(it);
    self->objects->erase(oit);
    PyObject* name = PyUnicode_FromString(oid.c_str());
    PyList_Append(out, name);
    Py_DECREF(name);
  }
  return out;
}

static PyObject* StoreCore_lookup(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  ObjEntry* e = FindEntry(self, oid);
  if (e == nullptr) Py_RETURN_NONE;
  return Py_BuildValue("(KKOO)", e->offset, e->size,
                       e->sealed ? Py_True : Py_False,
                       e->pinned ? Py_True : Py_False);
}

static PyObject* StoreCore_contains(StoreCoreObject* self, PyObject* args) {
  const char* oid;
  if (!PyArg_ParseTuple(args, "s", &oid)) return nullptr;
  ObjEntry* e = FindEntry(self, oid);
  if (e != nullptr && e->sealed) Py_RETURN_TRUE;
  Py_RETURN_FALSE;
}

static PyObject* StoreCore_fragmentation(StoreCoreObject* self, PyObject*) {
  uint64_t free_total = self->capacity - self->used;
  uint64_t largest = self->alloc->LargestFree();
  double frag = free_total == 0
                    ? 0.0
                    : 1.0 - static_cast<double>(largest) /
                                static_cast<double>(free_total);
  return Py_BuildValue("(dKn)", frag, largest,
                       static_cast<Py_ssize_t>(self->alloc->NumSpans()));
}

static PyObject* StoreCore_get_used(StoreCoreObject* self, void*) {
  return PyLong_FromUnsignedLongLong(self->used);
}

static PyObject* StoreCore_get_capacity(StoreCoreObject* self, void*) {
  return PyLong_FromUnsignedLongLong(self->capacity);
}

static PyObject* StoreCore_get_num_objects(StoreCoreObject* self, void*) {
  return PyLong_FromSize_t(self->objects->size());
}

static PyMethodDef StoreCore_methods[] = {
    {"alloc", reinterpret_cast<PyCFunction>(StoreCore_alloc), METH_VARARGS,
     "alloc(oid, size, pin=True) -> offset or -1"},
    {"seal", reinterpret_cast<PyCFunction>(StoreCore_seal), METH_VARARGS, ""},
    {"touch", reinterpret_cast<PyCFunction>(StoreCore_touch), METH_VARARGS, ""},
    {"pin", reinterpret_cast<PyCFunction>(StoreCore_pin), METH_VARARGS, ""},
    {"unpin", reinterpret_cast<PyCFunction>(StoreCore_unpin), METH_VARARGS, ""},
    {"free", reinterpret_cast<PyCFunction>(StoreCore_free), METH_VARARGS,
     "free(oid) -> size"},
    {"evict", reinterpret_cast<PyCFunction>(StoreCore_evict), METH_VARARGS,
     "evict(nbytes, grace_ticks=0) -> [oid]"},
    {"lookup", reinterpret_cast<PyCFunction>(StoreCore_lookup), METH_VARARGS,
     "lookup(oid) -> (offset, size, sealed, pinned) | None"},
    {"contains", reinterpret_cast<PyCFunction>(StoreCore_contains), METH_VARARGS,
     "contains(oid) -> sealed?"},
    {"fragmentation", reinterpret_cast<PyCFunction>(StoreCore_fragmentation),
     METH_NOARGS, "() -> (frag_ratio, largest_free, num_spans)"},
    {nullptr, nullptr, 0, nullptr}};

static PyGetSetDef StoreCore_getset[] = {
    {"used", reinterpret_cast<getter>(StoreCore_get_used), nullptr, "", nullptr},
    {"capacity", reinterpret_cast<getter>(StoreCore_get_capacity), nullptr, "",
     nullptr},
    {"num_objects", reinterpret_cast<getter>(StoreCore_get_num_objects), nullptr,
     "", nullptr},
    {nullptr, nullptr, nullptr, nullptr, nullptr}};

static PyTypeObject StoreCoreType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
    "ray_tpu_torch._native._store.StoreCore",     /* tp_name */
    sizeof(StoreCoreObject),                /* tp_basicsize */
};

static PyModuleDef store_module = {
    PyModuleDef_HEAD_INIT, "ray_tpu_torch._native._store",
    "plasma-style object store core (allocator + lifecycle + LRU)", -1,
    nullptr, nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__store(void) {
  StoreCoreType.tp_dealloc = reinterpret_cast<destructor>(StoreCore_dealloc);
  StoreCoreType.tp_flags = Py_TPFLAGS_DEFAULT;
  StoreCoreType.tp_doc = "object store bookkeeping core";
  StoreCoreType.tp_methods = StoreCore_methods;
  StoreCoreType.tp_getset = StoreCore_getset;
  StoreCoreType.tp_init = reinterpret_cast<initproc>(StoreCore_init);
  StoreCoreType.tp_new = StoreCore_new;
  if (PyType_Ready(&StoreCoreType) < 0) return nullptr;
  PyObject* m = PyModule_Create(&store_module);
  if (m == nullptr) return nullptr;
  Py_INCREF(&StoreCoreType);
  PyModule_AddObject(m, "StoreCore",
                     reinterpret_cast<PyObject*>(&StoreCoreType));
  return m;
}
