"""Data, tensor and pipeline parallelism across processes and devices.

Counterpart of nfdpm_tpu/parallel/ along its "data" axis (with parameter
partitioning) and the tensor parallelism, pipeline and spatial
partitioning of its "model" axis. The JAX package runs one program over a
device mesh and lets GSPMD place the collectives; the port runs one
process per rank (launched by torchrun) and places them itself, over
torch.distributed: NCCL between GPUs, gloo on the CPU or when asked for by
name.

distributed    : process-group start from torchrun's (or the JAX package's)
                 environment; the rank's rows of a global batch.
mesh           : the ("data", "model") mesh (world size, rank, each axis's
                 index and process group, local devices), row sharding,
                 replication, the coalesced gradient mean and the row
                 all-gather over the data axis.
tensor_parallel: the model axis's collectives as autograd functions
                 (Megatron's "f" and "g", the slab scatter and gather), and
                 whole states cut to a rank's slabs and gathered back.
sharding_rules : the JAX package's PartitionSpec rules (tensor-parallel
                 "model" entries and ZeRO "data" entries) as plain tuples,
                 their placements on the port's leaves.
zero           : a state partitioned over an axis: parameters, Adam moments
                 and EMA shadow over the data axis (ZeRO stage 3, fsdp),
                 gathered on use unit by unit, their gradients
                 reduce-scattered; the pipeline's stages; whole states.
pipeline       : GPipe over the K steps of stage 1 on the model axis.
spatial        : spatial partitioning: the flow's image rows over the model
                 axis in the train step (halo exchange, partial sums, the
                 latents' row gather).
part_parallel  : stage-2 training with each diffusion part on its own group
                 of ranks (tensor-parallel inside it under a model axis).
"""
