"""``paddle_tpu.incubate.distributed.models`` counterpart."""
