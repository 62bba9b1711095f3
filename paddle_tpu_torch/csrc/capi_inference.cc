// C inference API — the paddle/capi analog for deployment embedding; the
// port's copy of native/capi_inference.cc, which drives
// paddle_tpu_torch.runtime.capi_host (the one change) and is built by
// paddle_tpu_torch/runtime/lib.py load_capi() into
// paddle_tpu_torch/_build/capi-<hash>/libpaddle_tpu_torch_capi.so.
//
// Reference surface re-provided (capi/gradient_machine.h:36-88):
//   paddle_gradient_machine_create_for_inference  -> pti_create(model_dir)
//   paddle_gradient_machine_forward               -> pti_forward(...)
//   paddle_gradient_machine_destroy               -> pti_destroy
// plus pti_last_error() for diagnostics.
//
// Design: the reference's capi wraps its real C++ engine; this one wraps the
// port's fluid executor by EMBEDDING CPython (the reference itself embeds
// Python for data providers — PyDataProvider2.cpp precedent) and driving
// paddle_tpu_torch.runtime.capi_host.InferenceHost, which loads the exported
// inference bundle (fluid/io.py export_inference_model: pruned program JSON +
// params tar — the merged-model artifact of trainer/MergeModel.cpp:29) onto
// the card. Forward-only, thread-safe: every call takes the GIL (concurrent
// callers serialize).
//
// ABI (all through ctypes/dlopen; no C++ name mangling):
//   void* pti_create(const char* model_dir);
//   int   pti_forward(void* h,
//                     const void** inputs,      // n_inputs buffers
//                     const long long* shapes,  // concatenated dims
//                     const int* ndims,         // dims per input
//                     const int* dtypes,        // 0=f32 1=i32 per input
//                     int n_inputs,
//                     int fetch_index,          // which fetch target
//                     float* out_buf, long long out_capacity,
//                     long long* out_shape,     // >= PTI_MAX_NDIM entries
//                     int* out_ndim);           // <- results
//         returns number of f32 elements written, or -1 (error: see
//         pti_last_error) / -2 (out_buf too small; out_shape/out_ndim are
//         still filled so the caller can retry with a bigger buffer).
//   void  pti_destroy(void* h);
//   const char* pti_last_error(void);

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

thread_local std::string g_error;

void set_error_from_python() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  g_error = "python error";
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* msg = PyUnicode_AsUTF8(s);
      if (msg) g_error = msg;
      else PyErr_Clear();  // un-encodable message: keep the generic text
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

struct Host {
  PyObject* obj;  // paddle_tpu_torch.runtime.capi_host.InferenceHost
};

std::once_flag g_py_init;

void ensure_python() {
  // once_flag: concurrent first-time pti_create calls must not
  // double-initialize CPython (double PyEval_SaveThread is fatal)
  std::call_once(g_py_init, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
      // release the GIL acquired by initialization so pti_forward's
      // PyGILState_Ensure works from any thread
      PyEval_SaveThread();
    }
  });
}

}  // namespace

extern "C" {

// maximum output rank written to out_shape; callers size their buffer to this
#define PTI_MAX_NDIM 8

const char* pti_last_error(void) { return g_error.c_str(); }

void* pti_create(const char* model_dir) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  void* result = nullptr;
  PyObject* mod = PyImport_ImportModule("paddle_tpu_torch.runtime.capi_host");
  if (!mod) {
    set_error_from_python();
    PyGILState_Release(gil);
    return nullptr;
  }
  PyObject* cls = PyObject_GetAttrString(mod, "InferenceHost");
  Py_DECREF(mod);
  if (cls) {
    PyObject* obj = PyObject_CallFunction(cls, "s", model_dir);
    Py_DECREF(cls);
    if (obj) {
      Host* h = new Host{obj};
      result = h;
    } else {
      set_error_from_python();
    }
  } else {
    set_error_from_python();
  }
  PyGILState_Release(gil);
  return result;
}

int pti_forward(void* handle, const void** inputs, const long long* shapes,
                const int* ndims, const int* dtypes, int n_inputs,
                int fetch_index, float* out_buf, long long out_capacity,
                long long* out_shape, int* out_ndim) {
  if (!handle) {
    g_error = "null handle";
    return -1;
  }
  Host* h = static_cast<Host*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;

  // build [(bytes, (dims...), dtype_code), ...]
  PyObject* args_list = PyList_New(n_inputs);
  if (!args_list) {
    set_error_from_python();
    PyGILState_Release(gil);
    return -1;
  }
  long long shape_off = 0;
  for (int i = 0; i < n_inputs; i++) {
    long long numel = 1;
    PyObject* dims = PyTuple_New(ndims[i]);
    if (!dims) {
      set_error_from_python();
      Py_DECREF(args_list);
      PyGILState_Release(gil);
      return -1;
    }
    for (int d = 0; d < ndims[i]; d++) {
      long long dim = shapes[shape_off + d];
      numel *= dim;
      PyObject* dim_obj = PyLong_FromLongLong(dim);
      if (!dim_obj) {
        set_error_from_python();
        Py_DECREF(dims);
        Py_DECREF(args_list);
        PyGILState_Release(gil);
        return -1;
      }
      PyTuple_SET_ITEM(dims, d, dim_obj);
    }
    shape_off += ndims[i];
    size_t nbytes = (size_t)numel * 4;  // f32 and i32 are both 4 bytes
    PyObject* payload = PyBytes_FromStringAndSize(
        static_cast<const char*>(inputs[i]), (Py_ssize_t)nbytes);
    PyObject* dtype_obj = payload ? PyLong_FromLong(dtypes[i]) : nullptr;
    PyObject* entry =
        dtype_obj ? PyTuple_Pack(3, payload, dims, dtype_obj) : nullptr;
    Py_XDECREF(dtype_obj);
    Py_XDECREF(payload);
    Py_DECREF(dims);
    if (!entry) {
      set_error_from_python();
      Py_DECREF(args_list);
      PyGILState_Release(gil);
      return -1;
    }
    PyList_SET_ITEM(args_list, i, entry);  // steals entry
  }

  PyObject* res = PyObject_CallMethod(h->obj, "run_raw", "Oi", args_list,
                                      fetch_index);
  Py_DECREF(args_list);
  if (!res) {
    set_error_from_python();
    PyGILState_Release(gil);
    return -1;
  }
  // res = (bytes, (dims...))
  PyObject* payload = PyTuple_GetItem(res, 0);
  PyObject* dims = PyTuple_GetItem(res, 1);
  Py_ssize_t n_dims = PyTuple_Size(dims);
  long long numel = 1;
  for (Py_ssize_t d = 0; d < n_dims; d++) {
    long long v = PyLong_AsLongLong(PyTuple_GetItem(dims, d));
    if (out_shape && d < PTI_MAX_NDIM) out_shape[d] = v;
    numel *= v;
  }
  if (n_dims > PTI_MAX_NDIM) {
    g_error = "output rank exceeds PTI_MAX_NDIM";
    Py_DECREF(res);
    PyGILState_Release(gil);
    return -1;
  }
  if (out_ndim) *out_ndim = (int)n_dims;
  if (numel > out_capacity) {
    g_error = "output buffer too small";
    rc = -2;
  } else {
    memcpy(out_buf, PyBytes_AsString(payload), (size_t)numel * 4);
    rc = (int)numel;
  }
  Py_DECREF(res);
  PyGILState_Release(gil);
  return rc;
}

void pti_destroy(void* handle) {
  if (!handle) return;
  Host* h = static_cast<Host*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_DECREF(h->obj);
  PyGILState_Release(gil);
  delete h;
}

}  // extern "C"
