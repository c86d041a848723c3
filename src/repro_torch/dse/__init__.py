"""Design-space exploration — port of ``repro.dse``: the paper's FPGA
resource and latency model (``fpga_model``), its lookup-table search
(``search``), an H100 roofline of the recurrent stack (``gpu_model``, the
counterpart of the recurrent half of the reference's ``tpu_model``) and
its calibration against observed serving ticks (``calibrate``)."""
