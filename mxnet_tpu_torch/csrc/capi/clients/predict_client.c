/* A C predict client with no Python of its own: for each job it loads a
 * checkpoint, feeds one float32 input, writes the first output to a file
 * and times the predict call (set input, forward, read output) over
 * repeated calls.
 *
 *   predict_client REPS JOB [JOB ...]
 *   JOB = SYMBOL.json PARAMS INPUT.f32 OUTPUT.f32 NDIM D0 [D1 ...]
 *         [+NAME NDIM D0 [D1 ...] ...]
 *
 * INPUT.f32 holds prod(D) float32 values for the input "data" of shape
 * (D0, D1, ...) (token ids as floats for a language model). A "+NAME"
 * group declares another input's shape without setting it (a label whose
 * shape the graph cannot infer from the data's). For job k the
 * client prints "JOB k SHAPE d0 d1 ..." of the output, then
 * "JOB k MEDIAN_MS t" over REPS timed calls after the first. Exit status
 * 0 on success; on a failed call it prints MXGetLastError() and exits 1.
 *
 * Build against the port (see mxnet_tpu_torch/_capi.py):
 *   gcc predict_client.c -o predict_client <_capi.client_flags()>
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "c_predict_api.h"

#define CHECK(call)                                                   \
  do {                                                                \
    if ((call) != 0) {                                                \
      fprintf(stderr, "FAIL %s: %s\n", #call, MXGetLastError());      \
      return 1;                                                       \
    }                                                                 \
  } while (0)

static char* slurp(const char* path, long* size) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  fseek(f, 0, SEEK_END);
  *size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char* buf = (char*)malloc(*size + 1);
  if (fread(buf, 1, *size, f) != (size_t)*size) {
    fclose(f);
    free(buf);
    return NULL;
  }
  buf[*size] = 0;
  fclose(f);
  return buf;
}

static double now_ms(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec * 1e3 + ts.tv_nsec / 1e6;
}

static int cmp_double(const void* a, const void* b) {
  double x = *(const double*)a, y = *(const double*)b;
  return (x > y) - (x < y);
}

#define MAX_INPUTS 8
#define MAX_DIMS 64

/* One job's arguments from argv[*pos]: the files, "data"'s shape and the
 * "+NAME" groups; advances *pos. Returns the number of inputs, or 0. */
static int parse_job(int argc, char** argv, int* pos, const char** keys,
                     mx_uint* indptr, mx_uint* dims) {
  int i = *pos + 4, n = 0;
  keys[0] = "data";
  indptr[0] = 0;
  for (;;) {
    if (i >= argc || n >= MAX_INPUTS) return 0;
    int ndim = atoi(argv[i]);
    if (ndim < 1 || i + 1 + ndim > argc || indptr[n] + ndim > MAX_DIMS)
      return 0;
    for (int d = 0; d < ndim; ++d)
      dims[indptr[n] + d] = (mx_uint)atoi(argv[i + 1 + d]);
    indptr[n + 1] = indptr[n] + ndim;
    ++n;
    i += 1 + ndim;
    if (i + 1 < argc && argv[i][0] == '+' && n < MAX_INPUTS) {
      keys[n] = argv[i] + 1;
      ++i;
    } else {
      break;
    }
  }
  *pos = i;
  return n;
}

static int run_job(int job, int reps, char** argv, int n_inputs,
                   const char** keys, const mx_uint* indptr,
                   const mx_uint* dims) {
  long json_size = 0, param_size = 0, in_size = 0;
  char* json = slurp(argv[0], &json_size);
  char* params = slurp(argv[1], &param_size);
  float* input = (float*)slurp(argv[2], &in_size);
  if (!json || !params || !input) {
    fprintf(stderr, "job %d: cannot read the inputs\n", job);
    return 2;
  }
  mx_uint n_in = 1;
  for (mx_uint i = indptr[0]; i < indptr[1]; ++i) n_in *= dims[i];
  if ((long)n_in * 4 != in_size) {
    fprintf(stderr, "job %d: input holds %ld bytes, want %u floats\n", job,
            in_size, n_in);
    return 2;
  }
  PredictorHandle pred = NULL;
  /* dev_type 2 (gpu) as a deployment would pass it; the port's current
   * context decides */
  CHECK(MXPredCreate(json, params, (int)param_size, 2, 0, (mx_uint)n_inputs,
                     keys, indptr, dims, &pred));
  mx_uint* oshape = NULL;
  mx_uint ondim = 0, n_out = 1;
  CHECK(MXPredGetOutputShape(pred, 0, &oshape, &ondim));
  printf("JOB %d SHAPE", job);
  for (mx_uint i = 0; i < ondim; ++i) {
    printf(" %u", oshape[i]);
    n_out *= oshape[i];
  }
  printf("\n");
  float* out = (float*)malloc((size_t)n_out * 4);
  double* ms = (double*)malloc(sizeof(double) * reps);
  for (int r = 0; r <= reps; ++r) {
    double t0 = now_ms();
    CHECK(MXPredSetInput(pred, "data", input, n_in));
    CHECK(MXPredForward(pred));
    CHECK(MXPredGetOutput(pred, 0, out, n_out));
    if (r > 0) ms[r - 1] = now_ms() - t0;
    if (r == 0) {
      FILE* f = fopen(argv[3], "wb");
      if (!f || fwrite(out, 4, n_out, f) != n_out) return 3;
      fclose(f);
    }
  }
  qsort(ms, reps, sizeof(double), cmp_double);
  printf("JOB %d MEDIAN_MS %.6f\n", job,
         reps % 2 ? ms[reps / 2] : 0.5 * (ms[reps / 2 - 1] + ms[reps / 2]));
  fflush(stdout);
  CHECK(MXPredFree(pred));
  free(out);
  free(ms);
  free(json);
  free(params);
  free(input);
  return 0;
}

int main(int argc, char** argv) {
  int reps = argc > 1 ? atoi(argv[1]) : 0;
  if (argc < 8 || reps < 1) {
    fprintf(stderr,
            "usage: %s REPS SYMBOL PARAMS INPUT OUTPUT NDIM D0 [D1 ...] "
            "[+NAME NDIM D0 ...] [JOB ...]\n", argv[0]);
    return 2;
  }
  for (int job = 0, i = 2; i < argc; ++job) {
    const char* keys[MAX_INPUTS];
    mx_uint indptr[MAX_INPUTS + 1], dims[MAX_DIMS];
    char** files = argv + i;
    int n = parse_job(argc, argv, &i, keys, indptr, dims);
    if (n == 0) {
      fprintf(stderr, "job %d: malformed arguments\n", job);
      return 2;
    }
    int rc = run_job(job, reps, files, n, keys, indptr, dims);
    if (rc) return rc;
  }
  return 0;
}
