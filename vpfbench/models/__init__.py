"""One module a configuration: how the port builds the model from the
configuration's file, how the benchmark makes its weights from the seed,
and the model's FLOPs a frame, counted from the architecture's shapes."""
