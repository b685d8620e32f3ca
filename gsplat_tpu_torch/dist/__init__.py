"""Multi-GPU training on torch.distributed: the mesh (mesh.py), the
placement of the model and the camera batch over it (data.py), the
camera-batch x tile-band train steps and the eval step (spmd.py), their
collectives (collectives.py), and a launcher that runs one subprocess a
rank (launch.py). Port of
gsplat_tpu/dist/."""
