// envpool_lite — a minimal native batched-environment engine for MuJoCo.
//
// TPU-native equivalent of the reference's external envpool dependency (the
// C++ thread-pool batched env engine reached through PyCall at
// src/envs/envpool_env.jl:35-61): steps K MuJoCo environments in parallel on
// host threads, with TRUE snapshot/restore (qpos/qvel/time/ctrl copies)
// instead of envpool's restore-by-replay workaround
// (envpool_env.jl:112-125,167-182).
//
// Exposed as a plain C API consumed from Python via ctypes (no pybind11).
// Task-specific observation/reward follow the gymnasium v4 definitions so
// action-sequence replays cross-check against gym exactly (the reference's
// make_mujoco_gif.py correctness scheme).

#include <mujoco/mujoco.h>

#include <cmath>
#include <cstring>
#include <functional>
#include <string>
#include <thread>
#include <vector>

namespace {

enum TaskId : int {
  kHalfCheetah = 0,
  kSwimmer = 1,
  kHopper = 2,
  kWalker2d = 3,
  kAnt = 4,
  kHumanoid = 5,
  kHumanoidStandup = 6,
  kInvertedPendulum = 7,
  kInvertedDoublePendulum = 8,
  kReacher = 9,
  kPusher = 10,
};

inline double Clip(double v, double lo, double hi) {
  return std::fmin(std::fmax(v, lo), hi);
}

// ---------------------------------------------------------------------------
// Parallel-for over env indices (OpenMP).
// ---------------------------------------------------------------------------
class ThreadPool {
 public:
  explicit ThreadPool(int n) : nthreads_(n > 0 ? n : 1) {}

  void ParallelFor(int n, const std::function<void(int)>& fn) {
#pragma omp parallel for schedule(static) num_threads(nthreads_)
    for (int i = 0; i < n; ++i) fn(i);
  }

 private:
  int nthreads_;
};

struct Snapshot {
  std::vector<double> qpos, qvel, act;
  double time;
};

struct Engine {
  mjModel* model = nullptr;
  std::vector<mjData*> data;
  std::vector<Snapshot> snaps;
  ThreadPool* pool = nullptr;
  int num_envs = 0;
  int frame_skip = 5;
  int task = kHalfCheetah;
  int obs_dim = 0;
  // task-specific body ids (Reacher: fingertip/target; Pusher:
  // tips_arm/object/goal), resolved by name at creation
  int body_a = -1, body_b = -1, body_c = -1;
  double dt() const { return model->opt.timestep * frame_skip; }
};

// gymnasium humanoid mass_center: x of Σ body_mass·xipos / Σ body_mass
double MassCenterX(const Engine& e, const mjData* d) {
  double num = 0.0, den = 0.0;
  for (int b = 0; b < e.model->nbody; ++b) {
    num += e.model->body_mass[b] * d->xipos[3 * b];
    den += e.model->body_mass[b];
  }
  return num / den;
}

double Dist3(const mjData* d, int body_i, int body_j) {
  double s = 0.0;
  for (int c = 0; c < 3; ++c) {
    const double v = d->xpos[3 * body_i + c] - d->xpos[3 * body_j + c];
    s += v * v;
  }
  return std::sqrt(s);
}

// tasks whose observation/reward read force-related fields (cfrc_ext),
// which mj_step leaves stale — gymnasium calls mj_rnePostConstraint after
// stepping (mujoco_env.py::_step_mujoco_simulation)
bool NeedsRnePost(int task) {
  return task == kHumanoid || task == kHumanoidStandup;
}

int ObsDim(const Engine& e) {
  const int nq = e.model->nq, nv = e.model->nv, nb = e.model->nbody;
  switch (e.task) {
    case kHalfCheetah:  // qpos[1:] + qvel
    case kHopper:       // qpos[1:] + clip(qvel, ±10)
    case kWalker2d:
      return (nq - 1) + nv;
    case kSwimmer:  // qpos[2:] + qvel
      return (nq - 2) + nv;
    case kAnt:  // qpos[2:] + qvel (v4 default: no contact forces)
      return (nq - 2) + nv;
    case kHumanoid:  // qpos[2:]+qvel+cinert+cvel+qfrc_actuator+cfrc_ext
    case kHumanoidStandup:
      return (nq - 2) + nv + nb * 10 + nb * 6 + nv + nb * 6;
    case kInvertedPendulum:  // qpos + qvel
      return nq + nv;
    case kInvertedDoublePendulum:  // x, sin/cos(angles), clip(qvel), clip(qfrc_constraint)
      return 1 + 2 * (nq - 1) + nv + nv;
    case kReacher:  // cos/sin(θ), qpos[2:], qvel[:2], fingertip−target
      return 2 + 2 + (nq - 2) + 2 + 3;
    case kPusher:  // qpos[:7], qvel[:7], tips_arm, object, goal
      return 7 + 7 + 9;
  }
  return nq + nv;
}

void GetObs(const Engine& e, int i, double* out) {
  const mjData* d = e.data[i];
  const int nq = e.model->nq, nv = e.model->nv, nb = e.model->nbody;
  int k = 0;
  switch (e.task) {
    case kHumanoid:
    case kHumanoidStandup:
      for (int j = 2; j < nq; ++j) out[k++] = d->qpos[j];
      for (int j = 0; j < nv; ++j) out[k++] = d->qvel[j];
      for (int j = 0; j < nb * 10; ++j) out[k++] = d->cinert[j];
      for (int j = 0; j < nb * 6; ++j) out[k++] = d->cvel[j];
      for (int j = 0; j < nv; ++j) out[k++] = d->qfrc_actuator[j];
      for (int j = 0; j < nb * 6; ++j) out[k++] = d->cfrc_ext[j];
      return;
    case kInvertedPendulum:
      for (int j = 0; j < nq; ++j) out[k++] = d->qpos[j];
      for (int j = 0; j < nv; ++j) out[k++] = d->qvel[j];
      return;
    case kInvertedDoublePendulum:
      out[k++] = d->qpos[0];
      for (int j = 1; j < nq; ++j) out[k++] = std::sin(d->qpos[j]);
      for (int j = 1; j < nq; ++j) out[k++] = std::cos(d->qpos[j]);
      for (int j = 0; j < nv; ++j) out[k++] = Clip(d->qvel[j], -10.0, 10.0);
      for (int j = 0; j < nv; ++j)
        out[k++] = Clip(d->qfrc_constraint[j], -10.0, 10.0);
      return;
    case kReacher:
      out[k++] = std::cos(d->qpos[0]);
      out[k++] = std::cos(d->qpos[1]);
      out[k++] = std::sin(d->qpos[0]);
      out[k++] = std::sin(d->qpos[1]);
      for (int j = 2; j < nq; ++j) out[k++] = d->qpos[j];
      out[k++] = d->qvel[0];
      out[k++] = d->qvel[1];
      for (int c = 0; c < 3; ++c)
        out[k++] = d->xpos[3 * e.body_a + c] - d->xpos[3 * e.body_b + c];
      return;
    case kPusher:
      for (int j = 0; j < 7; ++j) out[k++] = d->qpos[j];
      for (int j = 0; j < 7; ++j) out[k++] = d->qvel[j];
      for (int c = 0; c < 3; ++c) out[k++] = d->xpos[3 * e.body_a + c];
      for (int c = 0; c < 3; ++c) out[k++] = d->xpos[3 * e.body_b + c];
      for (int c = 0; c < 3; ++c) out[k++] = d->xpos[3 * e.body_c + c];
      return;
    default:
      break;
  }
  const int skip = (e.task == kSwimmer || e.task == kAnt) ? 2 : 1;
  for (int j = skip; j < nq; ++j) out[k++] = d->qpos[j];
  for (int j = 0; j < nv; ++j) {
    double v = d->qvel[j];
    if (e.task == kHopper || e.task == kWalker2d) v = Clip(v, -10.0, 10.0);
    out[k++] = v;
  }
}

void StepOne(Engine& e, int i, const double* actions, double* obs, double* rew) {
  mjData* d = e.data[i];
  const int nu = e.model->nu;
  const double* a = actions + i * nu;
  double ctrl2 = 0.0;
  for (int j = 0; j < nu; ++j) ctrl2 += a[j] * a[j];

  // pre-step quantities per task (gymnasium v4 step() semantics)
  double pre0 = 0.0, pre1 = 0.0;
  switch (e.task) {
    case kHumanoid:
      pre0 = MassCenterX(e, d);
      break;
    case kReacher:  // reward uses PRE-step fingertip−target distance
      pre0 = Dist3(d, e.body_a, e.body_b);
      break;
    case kPusher:  // PRE-step distances: object−tips_arm, object−goal
      pre0 = Dist3(d, e.body_b, e.body_a);
      pre1 = Dist3(d, e.body_b, e.body_c);
      break;
    default:
      pre0 = d->qpos[0];  // x position before (forward-velocity tasks)
      break;
  }

  for (int j = 0; j < nu; ++j) d->ctrl[j] = a[j];
  for (int f = 0; f < e.frame_skip; ++f) mj_step(e.model, d);
  if (NeedsRnePost(e.task)) mj_rnePostConstraint(e.model, d);

  if (rew) {
    const double x_vel = (d->qpos[0] - pre0) / e.dt();
    double r = 0.0;
    switch (e.task) {
      case kHalfCheetah:
        r = x_vel - 0.1 * ctrl2;
        break;
      case kSwimmer:
        r = x_vel - 1e-4 * ctrl2;
        break;
      case kHopper:
      case kWalker2d:
        r = 1.0 + x_vel - 1e-3 * ctrl2;  // healthy + forward − ctrl
        break;
      case kAnt:
        r = 1.0 + x_vel - 0.5 * ctrl2;  // healthy + forward − ctrl (no contact cost)
        break;
      case kHumanoid:
        // humanoid_v4.py: 5.0 healthy + 1.25·ẋ(mass center) − 0.1·Σa²
        r = 5.0 + 1.25 * (MassCenterX(e, d) - pre0) / e.dt() - 0.1 * ctrl2;
        break;
      case kHumanoidStandup: {
        // humanoidstandup_v4.py: uph − 0.1·Σa² − min(0.5e-6·Σcfrc², 10) + 1
        double impact = 0.0;
        for (int j = 0; j < e.model->nbody * 6; ++j)
          impact += d->cfrc_ext[j] * d->cfrc_ext[j];
        impact = std::fmin(0.5e-6 * impact, 10.0);
        r = d->qpos[2] / e.model->opt.timestep - 0.1 * ctrl2 - impact + 1.0;
        break;
      }
      case kInvertedPendulum:
        // gym returns a constant 1.0 and TERMINATES at |angle|>0.2; a batch
        // rollout engine has no termination, so gate the alive bonus on the
        // healthy condition instead — the effective return is identical
        // while the pendulum stays up (inverted_pendulum_v4.py)
        r = (std::isfinite(d->qpos[1]) && std::fabs(d->qpos[1]) <= 0.2) ? 1.0
                                                                        : 0.0;
        break;
      case kInvertedDoublePendulum: {
        // inverted_double_pendulum_v4.py: post-step site 0 position
        const double x = d->site_xpos[0], y = d->site_xpos[2];
        const double dist_pen = 0.01 * x * x + (y - 2.0) * (y - 2.0);
        const double v1 = d->qvel[1], v2 = d->qvel[2];
        r = 10.0 - dist_pen - (1e-3 * v1 * v1 + 5e-3 * v2 * v2);
        break;
      }
      case kReacher:  // reacher_v4.py: −dist − Σa² (pre-step dist)
        r = -pre0 - ctrl2;
        break;
      case kPusher:  // pusher_v4.py: −dist(obj,goal) −0.1·Σa² −0.5·dist(obj,tips)
        r = -pre1 - 0.1 * ctrl2 - 0.5 * pre0;
        break;
    }
    rew[i] = r;
  }
  if (obs) GetObs(e, i, obs + i * e.obs_dim);
}

}  // namespace

extern "C" {

// Returns an opaque handle, or nullptr on failure (check epl_last_error).
static thread_local char g_error[1024];

const char* epl_last_error() { return g_error; }

void* epl_create(const char* xml_path, int num_envs, int frame_skip,
                 int task_id, int num_threads) {
  char err[512] = {0};
  mjModel* m = mj_loadXML(xml_path, nullptr, err, sizeof(err));
  if (!m) {
    snprintf(g_error, sizeof(g_error), "mj_loadXML failed: %s", err);
    return nullptr;
  }
  auto* e = new Engine;
  e->model = m;
  e->num_envs = num_envs;
  e->frame_skip = frame_skip;
  e->task = task_id;
  if (task_id == kReacher) {
    e->body_a = mj_name2id(m, mjOBJ_BODY, "fingertip");
    e->body_b = mj_name2id(m, mjOBJ_BODY, "target");
  } else if (task_id == kPusher) {
    e->body_a = mj_name2id(m, mjOBJ_BODY, "tips_arm");
    e->body_b = mj_name2id(m, mjOBJ_BODY, "object");
    e->body_c = mj_name2id(m, mjOBJ_BODY, "goal");
  }
  if (task_id == kReacher || task_id == kPusher) {
    if (e->body_a < 0 || e->body_b < 0 ||
        (task_id == kPusher && e->body_c < 0)) {
      snprintf(g_error, sizeof(g_error), "body name lookup failed for task %d",
               task_id);
      mj_deleteModel(m);
      delete e;
      return nullptr;
    }
  }
  e->obs_dim = ObsDim(*e);
  e->data.resize(num_envs);
  e->snaps.resize(num_envs);
  for (int i = 0; i < num_envs; ++i) e->data[i] = mj_makeData(m);
  int nthreads = num_threads > 0
                     ? num_threads
                     : static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads > num_envs) nthreads = num_envs;
  e->pool = new ThreadPool(nthreads);
  return e;
}

int epl_obs_dim(void* h) { return static_cast<Engine*>(h)->obs_dim; }
int epl_action_dim(void* h) { return static_cast<Engine*>(h)->model->nu; }
int epl_num_envs(void* h) { return static_cast<Engine*>(h)->num_envs; }
double epl_dt(void* h) { return static_cast<Engine*>(h)->dt(); }

void epl_ctrl_range(void* h, double* low, double* high) {
  Engine* e = static_cast<Engine*>(h);
  for (int j = 0; j < e->model->nu; ++j) {
    low[j] = e->model->actuator_ctrlrange[2 * j];
    high[j] = e->model->actuator_ctrlrange[2 * j + 1];
  }
}

// Deterministic reset (reset_noise_scale = 0): qpos0 / zero qvel.
void epl_reset(void* h, double* obs) {
  Engine* e = static_cast<Engine*>(h);
  e->pool->ParallelFor(e->num_envs, [&](int i) {
    mj_resetData(e->model, e->data[i]);
    mj_forward(e->model, e->data[i]);
    if (obs) GetObs(*e, i, obs + i * e->obs_dim);
  });
}

// actions: (num_envs, nu) row-major; obs: (num_envs, obs_dim); rew: (num_envs)
void epl_step(void* h, const double* actions, double* obs, double* rew) {
  Engine* e = static_cast<Engine*>(h);
  e->pool->ParallelFor(e->num_envs,
                       [&](int i) { StepOne(*e, i, actions, obs, rew); });
}

void epl_snapshot(void* h) {
  Engine* e = static_cast<Engine*>(h);
  e->pool->ParallelFor(e->num_envs, [&](int i) {
    Snapshot& s = e->snaps[i];
    const mjData* d = e->data[i];
    s.qpos.assign(d->qpos, d->qpos + e->model->nq);
    s.qvel.assign(d->qvel, d->qvel + e->model->nv);
    s.act.assign(d->act, d->act + e->model->na);
    s.time = d->time;
  });
}

void epl_restore(void* h) {
  Engine* e = static_cast<Engine*>(h);
  e->pool->ParallelFor(e->num_envs, [&](int i) {
    const Snapshot& s = e->snaps[i];
    mjData* d = e->data[i];
    std::memcpy(d->qpos, s.qpos.data(), sizeof(double) * e->model->nq);
    std::memcpy(d->qvel, s.qvel.data(), sizeof(double) * e->model->nv);
    if (e->model->na)
      std::memcpy(d->act, s.act.data(), sizeof(double) * e->model->na);
    d->time = s.time;
    mj_forward(e->model, d);
  });
}

// Broadcast env 0's current physics state to all envs.
void epl_sync_from_first(void* h) {
  Engine* e = static_cast<Engine*>(h);
  const mjData* src = e->data[0];
  e->pool->ParallelFor(e->num_envs, [&](int i) {
    if (i == 0) return;
    mjData* d = e->data[i];
    std::memcpy(d->qpos, src->qpos, sizeof(double) * e->model->nq);
    std::memcpy(d->qvel, src->qvel, sizeof(double) * e->model->nv);
    if (e->model->na) std::memcpy(d->act, src->act, sizeof(double) * e->model->na);
    d->time = src->time;
    mj_forward(e->model, d);
  });
}

void epl_destroy(void* h) {
  Engine* e = static_cast<Engine*>(h);
  delete e->pool;
  for (auto* d : e->data) mj_deleteData(d);
  mj_deleteModel(e->model);
  delete e;
}

}  // extern "C"
