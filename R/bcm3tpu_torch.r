# R interface to bcm3_tpu_torch, the PyTorch and CUDA port, via reticulate.
#
# The same R functions with the same formals as R/bcm3tpu.r, the drop-in
# replacement for the reference's C++ bridge loader (R/evaluate.r +
# bcmrbridge.so): analysis scripts written against R/evaluate_popPK.r /
# evaluate_PK.r keep working — source this file instead of evaluate.r.
#
# Backend: bcm3_tpu_torch.rbridge (Python), whose accessor contract is
# tested against the JAX package's bridge (tests/test_torch_rbridge.py).
# The models run on the CUDA card; set options(bcm3tpu.device = "cpu")
# before bcm3.init.cpp to run them on the CPU. This veneer adds no logic:
# each function is one reticulate call. Requires the `reticulate` package
# and a Python environment with bcm3_tpu_torch importable (set
# RETICULATE_PYTHON or use reticulate::use_python / use_virtualenv).

library(reticulate)

.bcm3tpu_torch <- NULL

.bcm3tpu_torch.module <- function() {
  if (is.null(.bcm3tpu_torch)) {
    .bcm3tpu_torch <<- reticulate::import("bcm3_tpu_torch.rbridge", delay_load = FALSE)
  }
  .bcm3tpu_torch
}

# --- lifecycle (reference: R/evaluate.r bcm3.init.cpp / release) ----------

bcm3.init.cpp <- function(bcm3, clparam = "", threads = NA) {
  mod <- .bcm3tpu_torch.module()
  bcm3$.cpp <- mod$init(bcm3$base_folder,
                        basename(bcm3$prior$file_name),
                        basename(bcm3$likelihood$file_name),
                        device = getOption("bcm3tpu.device", "cuda"))
  return(bcm3)
}

bcm3.reinit.cpp <- function(bcm3, clparam = "", threads = NA) {
  mod <- .bcm3tpu_torch.module()
  mod$cleanup(bcm3$.cpp)
  bcm3$.cpp <- mod$init(bcm3$base_folder,
                        basename(bcm3$prior$file_name),
                        basename(bcm3$likelihood$file_name),
                        device = getOption("bcm3tpu.device", "cuda"))
  return(bcm3)
}

bcm3.release.cpp <- function(bcm3) {
  mod <- .bcm3tpu_torch.module()
  mod$cleanup(bcm3$.cpp)
  bcm3$.cpp <- NULL
  return(bcm3)
}

# --- PopPK accessors (reference: R/evaluate_popPK.r) -----------------------

bcm3.popPK.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.popPK.get.observed.data <- function(bcm3) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$popPK_get_observed_data(bcm3$.cpp)
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$data <- res$data  # (timepoints, patients), as in the reference
  return(retval)
}

bcm3.popPK.get.simulated.data <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$popPK_get_simulated_data(bcm3$.cpp, as.numeric(param.values))
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$data <- res$data
  return(retval)
}

# --- single-patient PK ------------------------------------------------------

bcm3.PK.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.PK.get.simulated.trajectories <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$PK_get_simulated_trajectories(bcm3$.cpp, as.numeric(param.values))
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$data <- res$data
  return(retval)
}

# --- popPK full trajectories (reference: R/evaluate_popPK.r:54) -------------

bcm3.popPK.get.simulated.trajectories <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$popPK_get_simulated_trajectories(bcm3$.cpp, as.numeric(param.values))
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$concentrations <- res$concentrations   # (timepoints, patients)
  retval$trajectories <- res$trajectories       # (compartments, timepoints, patients)
  return(retval)
}

# --- ODE template (reference: R/evaluate_ODE.r) -----------------------------

bcm3.ODE.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.ODE.get.simulated.trajectories <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$ODE_get_simulated_trajectories(bcm3$.cpp, as.numeric(param.values)))
}

# --- pharmaco single patient (reference: R/evaluate_pharmacosingle.r) -------

bcm3.pharmacosingle.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.pharmacosingle.get.observed.data <- function(bcm3) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacosingle_get_observed_data(bcm3$.cpp)
  return(list(time = as.numeric(res$time), data = as.numeric(res$data)))
}

bcm3.pharmacosingle.get.simulated.data <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacosingle_get_simulated_data(bcm3$.cpp, as.numeric(param.values))
  return(list(time = as.numeric(res$time), data = as.numeric(res$data)))
}

bcm3.pharmacosingle.get.simulated.trajectory <- function(bcm3, param.values, timepoints) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacosingle_get_simulated_trajectory(bcm3$.cpp,
      as.numeric(param.values), as.numeric(timepoints))
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$concentrations <- as.numeric(res$concentrations)
  retval$trajectories <- res$trajectories  # (compartments, timepoints)
  return(retval)
}

# --- pharmaco population (reference: R/evaluate_pharmacopop.r) --------------

bcm3.pharmacopop.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.pharmacopop.get.num.patients <- function(bcm3) {
  mod <- .bcm3tpu_torch.module()
  return(mod$pharmacopop_get_num_patients(bcm3$.cpp))
}

bcm3.pharmacopop.get.observed.data <- function(bcm3, patient_ix) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacopop_get_observed_data(bcm3$.cpp, as.integer(patient_ix) - 1L)
  return(list(time = as.numeric(res$time), data = as.numeric(res$data)))
}

bcm3.pharmacopop.get.simulated.data <- function(bcm3, param.values, patient_ix) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacopop_get_simulated_data(bcm3$.cpp,
      as.numeric(param.values), as.integer(patient_ix) - 1L)
  return(list(time = as.numeric(res$time), data = as.numeric(res$data)))
}

bcm3.pharmacopop.get.simulated.trajectory <- function(bcm3, param.values, timepoints, patient_ix) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$pharmacopop_get_simulated_trajectory(bcm3$.cpp,
      as.numeric(param.values), as.integer(patient_ix) - 1L,
      as.numeric(timepoints))
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$concentrations <- as.numeric(res$concentrations)
  retval$trajectories <- res$trajectories
  return(retval)
}

# --- incucyte (reference: R/evaluate_incucyte.r) ----------------------------

bcm3.incucyte.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.incucyte.get.simulated.trajectories <- function(bcm3, param.values, experiment_ix = 1) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$incucyte_get_simulated_trajectories(bcm3$.cpp,
      as.numeric(param.values), as.integer(experiment_ix) - 1L)
  # matrices are (wells, timepoints); wells = [negative, positive, drug_1..]
  return(list(cell_count = res$cell_count,
              apoptotic_cell_count = res$apoptotic_cell_count,
              debris = res$debris,
              confluence = res$confluence,
              apoptosis_marker = res$apoptosis_marker))
}

bcm3.incucyte.get.simulated.ctb <- function(bcm3, param.values, experiment_ix = 1) {
  mod <- .bcm3tpu_torch.module()
  return(as.numeric(mod$incucyte_get_simulated_ctb(bcm3$.cpp,
      as.numeric(param.values), as.integer(experiment_ix) - 1L)))
}

# --- fISA (reference: R/evaluate_fISA.r) ------------------------------------

bcm3.fISA.get.likelihood <- function(bcm3, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.fISA.get.num.data <- function(bcm3, experiment) {
  mod <- .bcm3tpu_torch.module()
  return(mod$fISA_get_num_data(bcm3$.cpp, as.integer(experiment) - 1L))
}

bcm3.fISA.get.num.cell.lines <- function(bcm3, experiment) {
  mod <- .bcm3tpu_torch.module()
  return(mod$fISA_get_num_cell_lines(bcm3$.cpp, as.integer(experiment) - 1L))
}

bcm3.fISA.get.cell.line.names <- function(bcm3, experiment) {
  mod <- .bcm3tpu_torch.module()
  return(unlist(mod$fISA_get_cell_line_names(bcm3$.cpp, as.integer(experiment) - 1L)))
}

bcm3.fISA.get.observed.data <- function(bcm3, experiment, data.ix) {
  mod <- .bcm3tpu_torch.module()
  return(mod$fISA_get_observed_data(bcm3$.cpp,
      as.integer(experiment) - 1L, as.integer(data.ix) - 1L))
}

bcm3.fISA.get.modeled.data <- function(bcm3, experiment, data.ix, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(as.numeric(mod$fISA_get_modeled_data(bcm3$.cpp,
      as.integer(experiment) - 1L, as.integer(data.ix) - 1L,
      as.numeric(param.values))))
}

bcm3.fISA.get.modeled.activities <- function(bcm3, experiment, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$fISA_get_modeled_activities(bcm3$.cpp,
      as.integer(experiment) - 1L, as.numeric(param.values)))
}

# --- cellpop (reference: R/evaluate_cellpop.r) ------------------------------

bcm3.cellpop.get.likelihood <- function(bcm3, experiment, param.values) {
  mod <- .bcm3tpu_torch.module()
  return(mod$get_log_likelihood(bcm3$.cpp, as.numeric(param.values)))
}

bcm3.cellpop.get.num.species <- function(bcm3, experiment) {
  mod <- .bcm3tpu_torch.module()
  return(mod$cellpop_get_num_species(bcm3$.cpp, experiment))
}

bcm3.cellpop.get.species.name <- function(bcm3, experiment, species_ix) {
  mod <- .bcm3tpu_torch.module()
  names <- unlist(mod$cellpop_get_species_names(bcm3$.cpp, experiment))
  return(names[species_ix])
}

bcm3.cellpop.get.simulated.trajectories <- function(bcm3, experiment, param.values, max_cells=500) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$cellpop_get_simulated_trajectories(bcm3$.cpp,
      as.numeric(param.values), experiment)
  retval <- list()
  retval$time <- as.numeric(res$time)
  # (cells, timepoints, species) -> R's (species, timepoints, cells) aperm
  retval$cells <- aperm(res$values, c(3, 2, 1))
  retval$parents <- as.integer(res$parents) + 1L  # 1-based; 0 = initial
  return(retval)
}

bcm3.cellpop.get.observed.data <- function(bcm3, experiment, data_ix = 1, max_cells=500) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$cellpop_get_observed_data(bcm3$.cpp, as.integer(data_ix) - 1L, experiment)
  return(list(time = as.numeric(res$time), data = res$values))
}

bcm3.cellpop.get.simulated.data <- function(bcm3, experiment, param.values, data_ix = 1, max_cells=500) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$cellpop_get_simulated_data(bcm3$.cpp,
      as.numeric(param.values), as.integer(data_ix) - 1L, experiment)
  return(list(time = as.numeric(res$time), data = res$values))
}

bcm3.cellpop.get.matched.simulation <- function(bcm3, experiment, param.values, data_ix = 1, max_cells=500) {
  mod <- .bcm3tpu_torch.module()
  res <- mod$cellpop_get_matched_simulation(bcm3$.cpp,
      as.numeric(param.values), as.integer(data_ix) - 1L, experiment)
  retval <- list()
  retval$time <- as.numeric(res$time)
  retval$cells <- aperm(res$values, c(3, 2, 1))
  return(retval)
}
