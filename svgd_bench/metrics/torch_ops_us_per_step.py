"""Device microseconds a step of the kernels PyTorch, cuBLAS and the CUDA
runtime launch between the port's own (torch.func's elementwise ops, the
mesh search's ops, copies)."""


def read(ctx):
    s = ctx.layer_s.get("torch_ops")
    return None if s is None else s / ctx.steps * 1e6
