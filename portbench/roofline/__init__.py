"""The yardstick's arithmetic: the card's peaks and the operations and
bytes of the model and of the port's two kernels, computed from shapes."""
