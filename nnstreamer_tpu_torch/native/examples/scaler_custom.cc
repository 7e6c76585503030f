/**
 * scaler_custom.cc — example native custom-filter subplugin.
 *
 * Reference analog: tests/nnstreamer_example scaffolding subplugins
 * (passthrough/scaler fake backends used as deterministic test models).
 * Multiplies every float32 element by `mult:<f>` from the custom-props
 * string; identity otherwise.  Shape-polymorphic (set_input_info echoes
 * the input schema).
 *
 * Build: g++ -shared -fPIC -O2 -I../include scaler_custom.cc -o libscaler.so
 * (nnstreamer_tpu_torch.native.runtime.build_example("scaler_custom") runs
 * that command into build/torch_native/).
 */

#include <cstdlib>
#include <cstring>
#include <string>

#include "nns_tpu_custom_filter.h"

namespace {

struct Instance {
  float mult = 1.0f;
  nns_tensor_spec in_specs[NNS_TPU_TENSOR_LIMIT];
  uint32_t num_in = 0;
};

}  // namespace

extern "C" {

void *nns_custom_open (const char *custom_props)
{
  Instance *inst = new Instance ();
  if (custom_props != nullptr) {
    std::string s (custom_props);
    auto pos = s.find ("mult:");
    if (pos != std::string::npos)
      inst->mult = std::strtof (s.c_str () + pos + 5, nullptr);
  }
  return inst;
}

int nns_custom_get_model_info (void *, nns_tensor_spec *, uint32_t *,
    nns_tensor_spec *, uint32_t *)
{
  return 1; /* shape-polymorphic: use set_input_info */
}

int nns_custom_set_input_info (void *handle, const nns_tensor_spec *in_specs,
    uint32_t num_in, nns_tensor_spec *out_specs, uint32_t *num_out)
{
  Instance *inst = static_cast<Instance *> (handle);
  if (num_in > NNS_TPU_TENSOR_LIMIT)
    return -1;
  std::memcpy (inst->in_specs, in_specs, num_in * sizeof (nns_tensor_spec));
  inst->num_in = num_in;
  std::memcpy (out_specs, in_specs, num_in * sizeof (nns_tensor_spec));
  *num_out = num_in;
  return 0;
}

int nns_custom_invoke (void *handle, const nns_tensor_mem *inputs,
    uint32_t num_in, nns_tensor_mem *outputs, uint32_t num_out)
{
  Instance *inst = static_cast<Instance *> (handle);
  if (num_in != num_out)
    return -1;
  for (uint32_t i = 0; i < num_in; ++i) {
    if (outputs[i].nbytes < inputs[i].nbytes)
      return -2;
    if (i < inst->num_in && inst->in_specs[i].dtype == NNS_FLOAT32) {
      const float *src = static_cast<const float *> (inputs[i].data);
      float *dst = static_cast<float *> (outputs[i].data);
      uint64_t n = inputs[i].nbytes / sizeof (float);
      for (uint64_t j = 0; j < n; ++j)
        dst[j] = src[j] * inst->mult;
    } else {
      std::memcpy (outputs[i].data, inputs[i].data, inputs[i].nbytes);
    }
  }
  return 0;
}

void nns_custom_close (void *handle)
{
  delete static_cast<Instance *> (handle);
}

}  /* extern "C" */
