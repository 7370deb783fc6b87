/* Fast whitespace-separated numeric text parser (CPython extension).
 *
 * Native IO layer for the dataset text files: one read() and a
 * strtod/strtol sweep in place of the reference's fscanf-based loaders
 * (LSD/main_on_windows.cpp:27-64,97-124) and of numpy.loadtxt on the
 * large mapValue grids (1377x428 to 1958x1443 values).  The port's own
 * copy of the reference package's parser; host code, not a device
 * kernel.
 *
 * Exposed functions return raw bytes; the Python wrapper views them
 * with numpy.frombuffer (no numpy C API dependency here).
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>

static char *read_all(const char *path, size_t *len) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return nullptr;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  if (n < 0) {
    std::fclose(f);
    return nullptr;
  }
  std::fseek(f, 0, SEEK_SET);
  char *buf = (char *)std::malloc((size_t)n + 1);
  if (!buf) {
    std::fclose(f);
    return nullptr;
  }
  size_t got = std::fread(buf, 1, (size_t)n, f);
  std::fclose(f);
  buf[got] = '\0';
  *len = got;
  return buf;
}

/* parse_doubles(path) -> bytes of float64 */
static PyObject *parse_doubles(PyObject *, PyObject *args) {
  const char *path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  size_t len = 0;
  char *buf;
  Py_BEGIN_ALLOW_THREADS
  buf = read_all(path, &len);
  Py_END_ALLOW_THREADS
  if (!buf) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  size_t cap = 4096, n = 0;
  double *out = (double *)std::malloc(cap * sizeof(double));
  if (!out) {
    std::free(buf);
    return PyErr_NoMemory();
  }
  Py_BEGIN_ALLOW_THREADS
  {
    const char *p = buf;
    char *end;
    for (;;) {
      double v = std::strtod(p, &end);
      if (end == p) {
        /* skip one non-numeric char (handles stray text) or stop */
        if (*p == '\0') break;
        ++p;
        continue;
      }
      if (n == cap) {
        cap *= 2;
        double *nw = (double *)std::realloc(out, cap * sizeof(double));
        if (!nw) break;
        out = nw;
      }
      out[n++] = v;
      p = end;
    }
  }
  Py_END_ALLOW_THREADS
  std::free(buf);
  PyObject *res =
      PyBytes_FromStringAndSize((const char *)out, (Py_ssize_t)(n * 8));
  std::free(out);
  return res;
}

/* parse_grid(path, count) -> bytes of uint8 (values must be 0..255) */
static PyObject *parse_grid(PyObject *, PyObject *args) {
  const char *path;
  Py_ssize_t count;
  if (!PyArg_ParseTuple(args, "sn", &path, &count)) return nullptr;
  size_t len = 0;
  char *buf;
  Py_BEGIN_ALLOW_THREADS
  buf = read_all(path, &len);
  Py_END_ALLOW_THREADS
  if (!buf) {
    PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
    return nullptr;
  }
  unsigned char *out = (unsigned char *)std::malloc((size_t)count);
  if (!out) {
    std::free(buf);
    return PyErr_NoMemory();
  }
  Py_ssize_t n = 0;
  Py_BEGIN_ALLOW_THREADS
  {
    const char *p = buf;
    char *end;
    while (n < count) {
      long v = std::strtol(p, &end, 10);
      if (end == p) {
        if (*p == '\0') break;
        ++p;
        continue;
      }
      out[n++] = (unsigned char)v;
      p = end;
    }
  }
  Py_END_ALLOW_THREADS
  std::free(buf);
  if (n < count) {
    std::free(out);
    PyErr_Format(PyExc_ValueError, "%s: expected %zd values, got %zd",
                 path, count, n);
    return nullptr;
  }
  PyObject *res = PyBytes_FromStringAndSize((const char *)out, count);
  std::free(out);
  return res;
}

static PyMethodDef Methods[] = {
    {"parse_doubles", parse_doubles, METH_VARARGS,
     "Parse all float64 tokens in a text file; returns raw bytes."},
    {"parse_grid", parse_grid, METH_VARARGS,
     "Parse `count` integer tokens as uint8; returns raw bytes."},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_lsdtpu_torch_parser",
                                       "Fast dataset text parser.",
                                       -1,
                                       Methods,
                                       nullptr,
                                       nullptr,
                                       nullptr,
                                       nullptr};

PyMODINIT_FUNC PyInit__lsdtpu_torch_parser(void) {
  return PyModule_Create(&moduledef);
}
