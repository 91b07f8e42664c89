"""The yardstick's arithmetic, frozen here: the kernels' operations and
bytes (``kernels``), each family's FLOPs a token (``<family>``) and the
card's published peaks (``peaks.json``)."""
