/**
 * nns_tpu_custom_filter.h — C ABI for native custom filter subplugins.
 *
 * Reference analog: gst/nnstreamer/include/tensor_filter_custom.h (the
 * user-.so ABI loaded by tensor_filter_custom.c:338) and the v0/v1
 * framework ABI in nnstreamer_plugin_api_filter.h.  A shared object
 * implementing these four symbols can be run by the framework via
 * `tensor_filter framework=custom model=<path.so>`.
 *
 * Memory contract: the framework owns every buffer.  For invoke(), input
 * buffers are read-only; output buffers are pre-allocated by the framework
 * to the sizes advertised by get_model_info (or set_input_info) and must be
 * filled in place — the zero-copy analog of the reference's mapped
 * GstMemory.  No allocation crosses the ABI.
 *
 * The PyTorch port's copy of nnstreamer_tpu/native/include/, the same
 * ABI: a subplugin built against either header runs under either package.
 * The port hands the subplugin host memory (card tensors are copied to
 * the host before invoke).
 */

#ifndef NNS_TPU_CUSTOM_FILTER_H
#define NNS_TPU_CUSTOM_FILTER_H

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

#define NNS_TPU_ABI_VERSION 1
#define NNS_TPU_RANK_LIMIT 16
#define NNS_TPU_TENSOR_LIMIT 16

/* element types; values match the reference tensor_typedef.h enum order */
typedef enum {
  NNS_INT32 = 0,
  NNS_UINT32,
  NNS_INT16,
  NNS_UINT16,
  NNS_INT8,
  NNS_UINT8,
  NNS_FLOAT64,
  NNS_FLOAT32,
  NNS_INT64,
  NNS_UINT64,
  NNS_FLOAT16,
} nns_tensor_type;

typedef struct {
  uint32_t dtype;                      /* nns_tensor_type */
  uint32_t rank;                       /* <= NNS_TPU_RANK_LIMIT */
  uint64_t dims[NNS_TPU_RANK_LIMIT];   /* row-major, dims[0] outermost */
} nns_tensor_spec;

typedef struct {
  void *data;
  uint64_t nbytes;
} nns_tensor_mem;

/**
 * Create an instance.  custom_props is the raw string of the element's
 * `custom=` property ("" when unset).  Returns an opaque handle, or NULL
 * on failure.
 */
void *nns_custom_open (const char *custom_props);

/**
 * Static model schema.  Fill in/out spec arrays (capacity
 * NNS_TPU_TENSOR_LIMIT each) and counts.  Return 0 on success, nonzero if
 * the filter is shape-polymorphic (then set_input_info is used instead).
 */
int nns_custom_get_model_info (void *handle,
    nns_tensor_spec *in_specs, uint32_t *num_in,
    nns_tensor_spec *out_specs, uint32_t *num_out);

/**
 * Shape-polymorphic schema: given the negotiated input specs, fill the
 * output specs.  Optional symbol; needed only when get_model_info returns
 * nonzero.  Return 0 on success.
 */
int nns_custom_set_input_info (void *handle,
    const nns_tensor_spec *in_specs, uint32_t num_in,
    nns_tensor_spec *out_specs, uint32_t *num_out);

/**
 * Run one frame.  Inputs are read-only; outputs are pre-allocated and
 * filled in place.  Return 0 on success, nonzero on error.
 */
int nns_custom_invoke (void *handle,
    const nns_tensor_mem *inputs, uint32_t num_in,
    nns_tensor_mem *outputs, uint32_t num_out);

/** Destroy the instance. */
void nns_custom_close (void *handle);

#ifdef __cplusplus
}
#endif

#endif /* NNS_TPU_CUSTOM_FILTER_H */
