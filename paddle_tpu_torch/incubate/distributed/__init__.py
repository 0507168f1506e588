"""``paddle_tpu.incubate.distributed`` counterpart."""
