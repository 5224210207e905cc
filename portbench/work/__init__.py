"""The yardstick's arithmetic: the card's peaks, each kernel's bytes and
operations as a function of its shapes, the models' FLOPs, and the table
of kernel names."""
