"""Default configuration of an inversion run.

Counterpart of ``red_diffeq_tpu/config/default_config.py``: the same seven
sections and values (``pde``, ``model``, ``diffusion``, ``optimization``,
``data``, ``experiment``, ``tpu``), as a :class:`ConfigDict` of the port's
own. Of the ``tpu`` section the port reads ``solver_backend`` ('auto',
'plain' or 'kernel'; a file's 'xla' and 'pallas' are read as 'plain' and
'kernel') and ``solver_chunk``; ``use_scan`` (the JAX engine's whole-loop
scan) replays the step as a CUDA graph on the card
(``InversionEngine.optimize``); ``remat`` has no counterpart (the port
always recomputes each chunk in its backward); ``mesh_data`` x
``mesh_shot`` > 1 runs
the inversion over a device mesh (``parallel/mesh.py``); ``bf16_unet``
runs the U-Net in bf16.
"""
from red_diffeq_tpu_torch.config.config_utils import ConfigDict


def get_config() -> ConfigDict:
    config = ConfigDict()

    # PDE / acquisition geometry.
    config.pde = ConfigDict()
    config.pde.n_grid = 70       # physics grid size (square unless ng differs)
    config.pde.nt = 1000         # number of FD time steps
    config.pde.dx = 10.0         # grid spacing [m]
    config.pde.dt = 0.001        # time step [s]
    config.pde.nbc = 120         # absorbing sponge width [cells]
    config.pde.f = 15.0          # Ricker peak frequency [Hz]
    config.pde.sz = 10           # source depth [m]
    config.pde.gz = 10           # receiver depth [m]
    config.pde.ng = 70           # number of receivers
    config.pde.ns = 5            # number of sources (shots)

    # Denoiser U-Net.
    config.model = ConfigDict()
    config.model.dim = 64
    config.model.dim_mults = (1, 2, 4, 8)
    config.model.flash_attn = False
    config.model.channels = 1

    # Diffusion schedule.
    config.diffusion = ConfigDict()
    config.diffusion.image_size = 72
    config.diffusion.timesteps = 1000
    config.diffusion.sampling_timesteps = 250
    config.diffusion.objective = 'pred_noise'
    config.diffusion.model_path = 'pretrained_models/model-4.ckpt'

    # Inversion optimisation.
    config.optimization = ConfigDict()
    config.optimization.lr = 0.03
    config.optimization.ts = 300
    config.optimization.diffusion_ts = 1
    config.optimization.regularization = 'diffusion'
    config.optimization.reg_lambda = 0.75
    config.optimization.use_time_weight = False
    # Maximum timestep for diffusion regularisation (None = model's max).
    config.optimization.fixed_timestep = None
    config.optimization.sigma = 10.0
    config.optimization.sigma_x0 = 0.0001
    config.optimization.initial_type = 'smoothed'
    config.optimization.noise_std = 0.0
    config.optimization.noise_type = 'gaussian'
    config.optimization.missing_number = 0

    # Data.
    config.data = ConfigDict()
    config.data.seismic_data_dir = 'dataset/OpenFWI/Seismic_Data/'
    config.data.velocity_data_dir = 'dataset/OpenFWI/Velocity_Data/'
    config.data.batch_size = 1
    config.data.data_pattern = '*.npy'
    config.data.use_mmap = True

    # Experiment.
    config.experiment = ConfigDict()
    config.experiment.name = 'red_diffeq_default'
    config.experiment.results_dir = 'experiment/'
    config.experiment.save_intermediate = False
    config.experiment.log_interval = 10
    config.experiment.save_metrics = True
    config.experiment.random_seed = None

    # Solver and device section; the name is the JAX package's.
    config.tpu = ConfigDict()
    config.tpu.solver_backend = 'auto'
    config.tpu.solver_chunk = 20     # FD steps per chunk
    config.tpu.remat = True          # no counterpart
    config.tpu.mesh_data = 1         # batch shards
    config.tpu.mesh_shot = 1         # shot shards
    config.tpu.bf16_unet = False     # the U-Net in bf16

    return config


def get_marmousi_config() -> ConfigDict:
    """The Marmousi preset's data and experiment names."""
    config = get_config()
    config.data.seismic_data_dir = 'dataset/Marmousi/Seismic_Data/'
    config.data.velocity_data_dir = 'dataset/Marmousi/Velocity_Data/'
    config.data.batch_size = 1
    config.experiment.name = 'marmousi_inversion'
    return config
