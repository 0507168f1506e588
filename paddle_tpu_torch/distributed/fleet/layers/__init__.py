"""Fleet layers: the tensor-parallel ones (``mpu``)."""
