// C ABI binding: libza2c -- setup / prove / verify / verbose.
//
// Mirrors the reference C binding surface (binding/c/native/src/lib.rs:
// caller-provided buffers, error codes 0 / 1 / 2 / 100) as a thin C++
// shim embedding CPython and calling za_tpu.groth16.helper. The heavy
// compute still runs on the JAX engine inside the embedded
// interpreter.
//
// Build: see Makefile (g++ -shared -fPIC + libpython).

#include <Python.h>

#include <cstring>
#include <mutex>
#include <string>

namespace {

constexpr int ERR_NONE = 0;
constexpr int ERR_BUFFER_TOO_SMALL = 1;
constexpr int ERR_VERIFICATION_FAILED = 2;
constexpr int ERR_CUSTOM = 100;

std::once_flag g_init_once;
PyObject* g_helper = nullptr;   // za_tpu.groth16.helper module
PyObject* g_format = nullptr;   // za_tpu.groth16.format module
bool g_verbose = false;

void ensure_python() {
  std::call_once(g_init_once, [] {
    if (!Py_IsInitialized()) {
      Py_InitializeEx(0);
    }
    PyGILState_STATE gil = PyGILState_Ensure();
    PyRun_SimpleString(
        "import sys, os\n"
        "sys.setrecursionlimit(100000)\n"
        "root = os.environ.get('ZA_TPU_ROOT')\n"
        "if root and root not in sys.path:\n"
        "    sys.path.insert(0, root)\n");
    g_helper = PyImport_ImportModule("za_tpu.groth16.helper");
    g_format = PyImport_ImportModule("za_tpu.groth16.format");
    if (g_helper == nullptr || g_format == nullptr) {
      PyErr_Print();
    }
    PyGILState_Release(gil);
  });
}

int return_string(const std::string& s, char* buffer, size_t size, int ret) {
  if (s.size() >= size) {
    return ERR_BUFFER_TOO_SMALL;
  }
  std::memcpy(buffer, s.c_str(), s.size() + 1);
  return ret;
}

std::string py_error_string() {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  std::string msg = "unknown python error";
  if (value != nullptr) {
    PyObject* str = PyObject_Str(value);
    if (str != nullptr) {
      msg = PyUnicode_AsUTF8(str);
      Py_DECREF(str);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  return msg;
}

}  // namespace

extern "C" {

void verbose(int on) {
  ensure_python();
  g_verbose = on != 0;
  PyGILState_STATE gil = PyGILState_Ensure();
  PyRun_SimpleString(
      on ? "import logging; logging.getLogger('za_tpu')."
           "setLevel(logging.INFO); logging.basicConfig(level=logging.INFO)"
         : "import logging; logging.getLogger('za_tpu')."
           "setLevel(logging.WARNING)");
  PyGILState_Release(gil);
}

int setup(const char* circuit_path, const char* pk_path,
          const char* verifier_type, char* verifier_buffer,
          size_t verifier_buffer_size, char* error_buffer,
          size_t error_buffer_size) {
  ensure_python();
  std::string vt(verifier_type);
  if (vt != "json" && vt != "solidity") {
    return return_string("invalid validator type", error_buffer,
                         error_buffer_size, ERR_CUSTOM);
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* result =
      g_helper ? PyObject_CallMethod(g_helper, "setup", "sss", circuit_path,
                                     pk_path, verifier_type)
               : nullptr;
  int ret;
  if (result != nullptr) {
    const char* verifier = PyUnicode_AsUTF8(result);
    ret = return_string(verifier ? verifier : "", verifier_buffer,
                        verifier_buffer_size, ERR_NONE);
    Py_DECREF(result);
  } else {
    ret = return_string(py_error_string(), error_buffer, error_buffer_size,
                        ERR_CUSTOM);
  }
  PyGILState_Release(gil);
  return ret;
}

int prove(const char* pk_path, const char* inputs, char* proof_buffer,
          size_t proof_buffer_size, char* error_buffer,
          size_t error_buffer_size) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  int ret = ERR_CUSTOM;
  PyObject* flat =
      g_format ? PyObject_CallMethod(g_format, "flatten_json", "ss", "main",
                                     inputs)
               : nullptr;
  if (flat != nullptr) {
    PyObject* result =
        PyObject_CallMethod(g_helper, "prove", "sO", pk_path, flat);
    Py_DECREF(flat);
    if (result != nullptr) {
      const char* proof = PyUnicode_AsUTF8(result);
      ret = return_string(proof ? proof : "", proof_buffer, proof_buffer_size,
                          ERR_NONE);
      Py_DECREF(result);
      PyGILState_Release(gil);
      return ret;
    }
  }
  ret = return_string(py_error_string(), error_buffer, error_buffer_size,
                      ERR_CUSTOM);
  PyGILState_Release(gil);
  return ret;
}

int verify(const char* verifying_key, const char* proof_with_inputs,
           char* error_buffer, size_t error_buffer_size) {
  ensure_python();
  PyGILState_STATE gil = PyGILState_Ensure();
  PyObject* result =
      g_helper ? PyObject_CallMethod(g_helper, "verify", "ss", verifying_key,
                                     proof_with_inputs)
               : nullptr;
  int ret;
  if (result != nullptr) {
    ret = PyObject_IsTrue(result) ? ERR_NONE : ERR_VERIFICATION_FAILED;
    Py_DECREF(result);
  } else {
    ret = return_string(py_error_string(), error_buffer, error_buffer_size,
                        ERR_CUSTOM);
  }
  PyGILState_Release(gil);
  return ret;
}

}  // extern "C"
