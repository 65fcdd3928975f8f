"""Process groups as a ('data', 'model') mesh (driving_dirty_tpu/parallel/mesh.py).

One process is one rank, on one device. The world's ranks form a grid of
`data` rows by `model` columns in row-major order (rank = d * model + m,
as the JAX package reshapes its device list):

  * `initialize_distributed` joins the world: a launcher's group
    (WORLD_SIZE, RANK, LOCAL_RANK), the DD_COORDINATOR_ADDRESS /
    DD_NUM_PROCESSES / DD_PROCESS_ID nodes of the JAX package, or the ranks
    parallel/launch.py spawns (`join`);
  * `build_mesh(num_devices, model_parallel)` -> a `Mesh` holding this
    rank's coordinates and its two groups: `dp_group` (the ranks of its
    'model' column, which split the batch) and `tp_group` (the ranks of its
    'data' row, which split the 'model'-sharded weights);
  * `param_shardings(mesh, model, rules)`: the task's sharding rules, written
    on the JAX layouts and paths as the JAX package writes them, as
    {parameter name: None (replicated) or (dim, "model")} on this package's
    layouts (a JAX HWIO conv weight's output dimension, 3, lands on dim 0 of
    an OIHW Conv2d weight and dim 1 of a ConvTranspose2d's [in, out, kh,
    kw]); `shard_module` cuts the parameters to this rank's shard.

Backend: NCCL where every rank has a card of its own; gloo on the CPU, and
gloo where the caller named one card for every rank (`--device cuda:K`),
which NCCL refuses. The choice is printed once by rank 0; a failed NCCL
initialization raises. Every group has a timeout (TIMEOUT), so a mismatched
collective fails instead of hanging. Decisions on the host (stop flags,
validation sums) travel over gloo groups on the CPU, made beside NCCL ones.

During a training step the trainer sets the mesh as the step's data split
(`data_parallel_step`): BatchNorm statistics, dropout draws and loss
normalizers then cover the global batch (parallel/collectives.py). Outside
it (validation, inference, one process) the layers are the one-process code.
"""
from __future__ import annotations

import os
from contextlib import contextmanager
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

TIMEOUT = timedelta(seconds=120)

_DEVICE: torch.device | None = None  # this rank's device, set on joining
_STEP: "Mesh | None" = None          # the mesh of the running training step


def spec(*axes):
    """A PartitionSpec of the JAX package as a tuple: one entry per array
    dimension, "model" where it is cut across the 'model' axis, else None."""
    return tuple(axes)


def backend_for(device) -> tuple[str, str]:
    """-> (backend, why) for ranks on `device`: "cuda" alone means a card per
    rank (cuda:LOCAL_RANK)."""
    device = torch.device(device)
    if device.type == "cpu":
        return "gloo", "ranks on the CPU"
    if device.index is not None:
        return "gloo", f"every rank on the one card the caller named ({device}), which NCCL refuses"
    return "nccl", "a card per rank"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of local rank `local_rank`: "cuda" -> cuda:local_rank (the
    card must exist), a named card or the CPU as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        if not torch.cuda.is_available() or local_rank >= torch.cuda.device_count():
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            raise RuntimeError(f"local rank {local_rank} needs cuda:{local_rank}, and this host has "
                               f"{n} card(s); name one card (--device cuda:0) to share it over gloo")
        return torch.device("cuda", local_rank)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


def join(init_method: str, world_size: int, rank: int, local_rank: int, device) -> torch.device:
    """Join a world of `world_size` ranks as `rank` through `init_method`
    (env://, tcp://host:port or file://path) -> this rank's device."""
    global _DEVICE
    backend, why = backend_for(device)
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank,
                            timeout=TIMEOUT)
    if rank == 0:
        print(f"[mesh] {world_size} ranks, backend {backend}: {why}", flush=True)
    if backend == "nccl":
        probe = torch.ones(1, device=dev)  # NCCL connects lazily: fail here, not mid-step
        dist.all_reduce(probe)
        if probe.item() != world_size:
            raise RuntimeError(f"NCCL all_reduce probe gave {probe.item()}, expected {world_size}")
    _DEVICE = dev
    return dev


def node_rendezvous(num_nodes: int = 1, coordinator_address: str | None = None,
                    num_processes: int | None = None, process_id: int | None = None):
    """The JAX package's node settings -> (init_method, nodes, this node) or
    None for one node without a coordinator: `coordinator_address` (or
    DD_COORDINATOR_ADDRESS; host:port, or a URL such as file://path),
    `num_processes` nodes (DD_NUM_PROCESSES, default num_nodes) and this
    node's `process_id` (DD_PROCESS_ID, default 0)."""
    env = os.environ
    ca = coordinator_address or env.get("DD_COORDINATOR_ADDRESS")
    if ca is None:
        if num_nodes > 1:
            raise ValueError(f"--num_nodes {num_nodes} needs a coordinator: set DD_COORDINATOR_ADDRESS, "
                             f"DD_NUM_PROCESSES and DD_PROCESS_ID on every node, or start the ranks "
                             f"with a launcher (torchrun)")
        return None
    nodes = int(num_processes if num_processes is not None else env.get("DD_NUM_PROCESSES", num_nodes))
    node = int(process_id if process_id is not None else env.get("DD_PROCESS_ID", 0))
    return (ca if "://" in ca else f"tcp://{ca}"), nodes, node


def launched() -> bool:
    """A launcher (torchrun) started this process as a rank."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def initialize_distributed(num_nodes: int = 1, coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None, *,
                           device="cuda", local_rank: int = 0, local_size: int = 1) -> bool:
    """Join the world this process belongs to -> True, or False when it runs
    alone (one node, no coordinator, no launcher).

    A launcher's environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT, as torchrun sets them) is joined as it stands. Otherwise
    nodes are found as the JAX package finds them (`node_rendezvous`); a
    node runs `local_size` ranks, and this process is its
    `local_rank`-th."""
    if dist.is_initialized():
        return True
    if coordinator_address is None and "DD_COORDINATOR_ADDRESS" not in os.environ and launched():
        env = os.environ
        join("env://", int(env["WORLD_SIZE"]), int(env["RANK"]), int(env.get("LOCAL_RANK", 0)), device)
        return True
    nodes = node_rendezvous(num_nodes, coordinator_address, num_processes, process_id)
    if nodes is None:
        return False
    init, n, node = nodes
    join(init, n * local_size, node * local_size + local_rank, local_rank, device)
    return True


def current_device() -> torch.device | None:
    """This rank's device once it joined a world, else None."""
    return _DEVICE if dist.is_initialized() else None


@dataclass(eq=False)
class Mesh:
    """This rank's place in the ('data', 'model') grid and its groups.
    `cpu_group` (the world) and `cpu_dp_group` are gloo groups for host
    values; under gloo they are the device groups themselves."""

    data: int
    model: int
    rank: int
    dp_rank: int
    tp_rank: int
    dp_group: object
    tp_group: object
    cpu_group: object
    cpu_dp_group: object
    device: torch.device
    backend: str

    @property
    def is_first(self) -> bool:
        """Rank (0, 0): the one that logs and writes checkpoints."""
        return self.rank == 0


def build_mesh(num_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The world as a (num_devices / model_parallel, model_parallel) grid.
    Every rank of the world calls this, in the same order as every other
    collective call."""
    if not dist.is_initialized():
        raise ValueError(f"a mesh of {num_devices or 1} devices with model_parallel={model_parallel} "
                         f"needs that many ranks in a world: start them with --gpus / --num_nodes "
                         f"(parallel/launch.py) or a launcher")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks: one rank is one device")
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    data, model = n // model_parallel, model_parallel
    rank = dist.get_rank()
    backend = dist.get_backend()
    dp_rank, tp_rank = divmod(rank, model)

    def groups(backend_=None):
        rows = [dist.new_group([d * model + m for m in range(model)], timeout=TIMEOUT, backend=backend_)
                for d in range(data)]
        cols = [dist.new_group([d * model + m for d in range(data)], timeout=TIMEOUT, backend=backend_)
                for m in range(model)]
        return rows[dp_rank], cols[tp_rank]

    tp_group, dp_group = groups()
    if backend == "gloo":
        cpu_group, cpu_dp_group = dist.group.WORLD, dp_group
    else:
        cpu_group = dist.new_group(list(range(world)), timeout=TIMEOUT, backend="gloo")
        _, cpu_dp_group = groups("gloo")
    device = _DEVICE or torch.device("cpu")
    return Mesh(data, model, rank, dp_rank, tp_rank, dp_group, tp_group, cpu_group, cpu_dp_group,
                device, backend)


@contextmanager
def data_parallel_step(mesh: Mesh | None):
    """Within: a training step on this rank's rows of the global batch
    (read by parallel/collectives.py:step_split)."""
    global _STEP
    before, _STEP = _STEP, (mesh if mesh is not None and mesh.data > 1 else None)
    try:
        yield
    finally:
        _STEP = before


def step_mesh() -> Mesh | None:
    """The mesh of the running data-parallel training step, else None."""
    return _STEP


# ----------------------------------------------------------------------------
# parameters


def param_shardings(mesh: Mesh, model, rules=None) -> dict:
    """{parameter name: None or (dim, "model")} for every parameter of
    `model`. `rules(path, leaf)` gets the JAX package's path tuple (e.g.
    ("encoder", "fc1", "fc", "w")) and the parameter in the JAX layout (a
    permuted view), and returns a `spec` or None (replicated), as the JAX
    package's param_sharding_rules do; the spec's dimension is carried to
    this package's layout."""
    from driving_dirty_tpu_torch.checkpoints.convert import param_places

    params = dict(model.named_parameters())
    out = {}
    for jax_name, name, perm in param_places(model):
        p = params[name]
        s = rules(tuple(jax_name.split("/")), p if perm is None else p.permute(perm)) if rules else None
        if s is None or all(a is None for a in s):
            out[name] = None
            continue
        if list(s).count("model") != 1 or any(a not in (None, "model") for a in s):
            raise NotImplementedError(f"{jax_name}: spec {s}; only one dimension on 'model' is supported")
        j = list(s).index("model")
        dim = j if perm is None else perm[j]
        if p.shape[dim] % mesh.model:
            raise ValueError(f"{name}: dimension {dim} of {tuple(p.shape)} does not divide over "
                             f"{mesh.model} model-parallel ranks")
        out[name] = (dim, "model")
    return out


def local_shard(mesh: Mesh, t: torch.Tensor, sharding) -> torch.Tensor:
    """This rank's block of a full tensor under `sharding` (a contiguous copy)."""
    if sharding is None:
        return t
    dim = sharding[0]
    k = t.shape[dim] // mesh.model
    return t.narrow(dim, mesh.tp_rank * k, k).contiguous()


def _out_dim(mod) -> int:
    """The output-channel dimension of a conv layer's weight: 0 of a
    Conv2d's OIHW, 1 of a ConvTranspose2d's [in, out, kh, kw]."""
    from driving_dirty_tpu_torch.core.layers import ConvTranspose2d

    return 1 if isinstance(mod, ConvTranspose2d) else 0


def shard_module(model, mesh: Mesh, specs: dict) -> None:
    """Cut `model`'s sharded parameters to this rank's blocks, and set each
    layer that holds one to run tensor-parallel: a Linear layer
    column-parallel (weight cut on its output dimension, with its bias) or
    row-parallel (cut on its input dimension; the bias stays whole), a
    Conv2d or ConvTranspose2d column-parallel (weight and bias cut on the
    output channels). Other sharded layers or cuts are not supported."""
    from driving_dirty_tpu_torch.checkpoints.convert import shard_params
    from driving_dirty_tpu_torch.core.layers import Conv2d, ConvTranspose2d, Linear

    sharded = {n for n, s in specs.items() if s is not None}
    for path, mod in model.named_modules():
        own = {f"{path}.{k}" if path else k for k, _ in mod.named_parameters(recurse=False)}
        mine = own & sharded
        if not mine:
            continue
        prefix = f"{path}." if path else ""
        if not isinstance(mod, (Linear, Conv2d, ConvTranspose2d)):
            raise NotImplementedError(f"{sorted(mine)}: only Linear and conv layers shard over 'model' here")
        wdim = specs[prefix + "weight"][0] if prefix + "weight" in mine else None
        bias = prefix + "bias" in mine
        out = 0 if isinstance(mod, Linear) else _out_dim(mod)
        if wdim == out and bias:
            mod.tp = ("column", mesh)
        elif isinstance(mod, Linear) and wdim == 1 and not bias:
            mod.tp = ("row", mesh)
        else:
            raise NotImplementedError(f"{path}: weight on dim {wdim} with the bias "
                                      f"{'cut' if bias else 'whole'} is not a parallel "
                                      f"{type(mod).__name__} this package runs")
        names = [k for k in ("weight", "bias") if prefix + k in mine]
        cut = shard_params({k: getattr(mod, k).detach() for k in names}, mesh,
                           {k: specs[prefix + k] for k in names})
        for k in names:
            setattr(mod, k, torch.nn.Parameter(cut[k], requires_grad=getattr(mod, k).requires_grad))


def unshard_module(model, mesh: Mesh, specs: dict) -> None:
    """The inverse of `shard_module`: every rank gets the whole parameters
    back (gathered over 'model') and the layers run whole again."""
    from driving_dirty_tpu_torch.checkpoints.convert import gather_params

    params = dict(model.named_parameters())
    whole = gather_params({n: p.detach() for n, p in params.items()}, mesh, specs)
    for path, mod in model.named_modules():
        if getattr(mod, "tp", None) is None:
            continue
        prefix = f"{path}." if path else ""
        for k in ("weight", "bias"):
            if specs.get(prefix + k) is not None:
                setattr(mod, k, torch.nn.Parameter(whole[prefix + k],
                                                   requires_grad=params[prefix + k].requires_grad))
        mod.tp = None
