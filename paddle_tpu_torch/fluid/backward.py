"""append_backward — add gradient computation to a program.

Reference: fluid/backward.py:6 append_backward_ops -> C++ AppendBackward
(framework/backward.cc:343,414) emits one grad-op per forward op plus sum-ops
for fan-in. Redesign: ONE ``autodiff_grad`` op marks 'differentiate
the forward prefix w.r.t. these parameters'; the executor lowers it through
torch.autograd at run time (executor._run_autodiff). Grad vars are still real
descs named ``<param>@GRAD`` (the reference's GradVarName convention,
framework/operator.h) so optimizer ops wire up identically.
"""

from __future__ import annotations

from typing import List, Optional

from .framework import Program, Variable, default_main_program


def append_backward(loss: Variable, parameter_list: Optional[List[str]] = None,
                    program: Optional[Program] = None) -> List[tuple]:
    """Append grad computation for ``loss``; returns [(param_var, grad_var)]."""
    program = program or default_main_program()
    block = program.global_block()
    if parameter_list is None:
        parameter_list = [v.name for v in block.all_parameters()]
    grad_vars = []
    for pname in parameter_list:
        pvar = block.var(pname)
        gvar = block.create_var(name=pname + "@GRAD", shape=pvar.shape,
                                dtype=pvar.dtype)
        grad_vars.append((pvar, gvar))
    block.append_op(
        "autodiff_grad",
        inputs={"Loss": [loss.name], "Params": list(parameter_list)},
        outputs={"Grads": [p + "@GRAD" for p in parameter_list]},
        attrs={"loss": loss.name, "params": list(parameter_list),
               "num_fwd_ops": len(block.ops)})
    return grad_vars
