"""``mx.contrib``: the contrib operators (``contrib.ops``: CTC, FFT, count
sketch, quantize / dequantize, the SSD MultiBox trio and MultiProposal)
and ``contrib.autograd``, the alias of ``mx.autograd``, as in the JAX
package's ``contrib/``."""
from . import ops  # noqa: F401 — registers the contrib ops
from .. import autograd  # noqa: F401 — mx.contrib.autograd
