// The RACER Dubins elevation model with suspension, three LSTMs and the
// propagated 4 x 4 covariance (RacerDubinsElevationLSTMUncertainty, 26
// states), for the rollout, solve and sampling kernels, on flat ground or on
// an elevation map: the uncertainty form (kUnc) of the suspension model's
// step in racer_elev_susp.cuh, which documents both. Beside the suspension
// model's step it carries the quadratic brake, the mean LSTM (11 -> 16, head
// 27-16-2) correcting the velocity and yaw rates, the uncertainty LSTM (12 ->
// 16, head 28-16-5) whose sigmoid-scaled outputs give Q, and static settling
// of its static roll and pitch on the map.
#pragma once

#include "racer_elev_susp.cuh"

using RacerLSTMUnc = RacerElevSuspT<true>;
