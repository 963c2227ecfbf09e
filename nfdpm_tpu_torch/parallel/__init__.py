"""Data parallelism across processes and devices.

Counterpart of nfdpm_tpu/parallel/ along its "data" axis. The JAX package
runs one program over a device mesh and lets GSPMD place the collectives;
the port runs one process per rank (launched by torchrun) and places them
itself, over torch.distributed: NCCL between GPUs, gloo on the CPU or when
asked for by name.

distributed   : process-group start from torchrun's (or the JAX package's)
                environment; the rank's rows of a global batch.
mesh          : the data-axis mesh (world size, rank, process group, local
                devices), row sharding, replication, the coalesced gradient
                mean and the row all-gather.
sharding_rules: the JAX package's PartitionSpec rules (tensor-parallel
                "model" entries and ZeRO "data" entries) as plain tuples, and
                the Adam moments' partition over the data axis (ZeRO).
part_parallel : stage-2 training with each diffusion part on its own group
                of ranks.

The "model" axis (tensor parallelism of the coupling CNN and the UNet,
pipelining, spatial partitioning) is not here: make_mesh(n_model > 1)
raises NotImplementedError.
"""
