"""The benchmark's frozen arithmetic: the card's published peaks
(``peaks``), the operations and bytes of the port's kernels K1-K3
(``kernels``), and the operations of a configuration's network, counted
on the plain reference (``model_flops``)."""
