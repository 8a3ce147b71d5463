"""Generate the full-surface PX4 parameter dump for the simulated hexa.

Copied from ``tools/gen_px4_params.py`` (numpy-free, pure Python), over the
port's copy of ``io/px4_params.py::dump_params_file``: its output is the
committed ``configs/params_hexa_full.params``, byte for byte (the header
inside the file names the original generator, as the committed dump does).
Every value is either a PX4 v1.13 multirotor default or an explicit
override for the MPC-offboard setup; the overrides are what
``cli/mission.py``'s ``push_params`` applies preflight.

Format: QGroundControl plain text, one param per line,
``vid  cid  NAME  value  type`` with MAV_PARAM_TYPE 6 (INT32) / 9 (REAL32).

    python -m sde4mbrl_px4_tpu_torch.sim.gen_px4_params [out_path]

writes to ``out_path``, by default ``build/params_hexa_full.params`` (never
over the committed file unless that path is given).
"""
from __future__ import annotations

import os
import sys
from typing import Optional

from sde4mbrl_px4_tpu_torch.io.px4_params import dump_params_file

__all__ = ["HEADER", "build_params", "main"]

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

HEADER = """Onboard parameters for the sde4mbrl_px4_tpu simulated hexacopter.

Stack: PX4 Pro (v1.13 parameter surface)
Vehicle: Multi-Rotor, hexa X (SYS_AUTOSTART 6001)
GENERATED by tools/gen_px4_params.py — do not hand-edit; the MPC-offboard
overrides live in the generator and configs/params_hexa.params is the
preflight push subset (MissionControl.push_params).
Provenance: every value is either a public PX4 v1.13 firmware DEFAULT
(unmodified params necessarily match any other vehicle's dump line-for-
line — same facts, same canonical QGC exporter format) or an explicit
override for this simulated vehicle, chosen in the generator."""


def build_params() -> dict:
    p: dict = {}

    # ---- system / airframe -------------------------------------------------
    p.update({
        "SYS_AUTOSTART": 6001,        # generic hexa X
        "SYS_AUTOCONFIG": 0,
        "SYS_CAL_ACCEL": 0, "SYS_CAL_BARO": 0, "SYS_CAL_GYRO": 0,
        "SYS_CAL_TDEL": 24, "SYS_CAL_TMAX": 10, "SYS_CAL_TMIN": 5,
        "SYS_CTRL_ALLOC": 0,
        "SYS_FAILURE_EN": 0,
        "SYS_HAS_BARO": 1, "SYS_HAS_MAG": 1,
        "SYS_HITL": 0,
        "SYS_MC_EST_GROUP": 2,        # EKF2
        "SYS_RESTART_TYPE": 2,
        "SYS_STCK_EN": 1,
        "SYS_USE_IO": 1,
    })

    # ---- MAVLink links ------------------------------------------------------
    # TELEM2 is the MPC side-channel: onboard mode, high rate, the 921600
    # UART the router splits (reference scripts/router_hexa.conf:2-4).
    p.update({
        "MAV_SYS_ID": 1, "MAV_COMP_ID": 1, "MAV_TYPE": 13,  # hexarotor
        "MAV_0_CONFIG": 101, "MAV_0_FORWARD": 1, "MAV_0_MODE": 0,
        "MAV_0_RADIO_CTL": 1, "MAV_0_RATE": 1200,
        "MAV_1_CONFIG": 102, "MAV_1_FORWARD": 0, "MAV_1_MODE": 2,
        "MAV_1_RADIO_CTL": 0, "MAV_1_RATE": 92160,
        "MAV_2_CONFIG": 0,
        "MAV_HB_FORW_EN": 1,
        "MAV_PROTO_VER": 2,           # the custom dialect is MAVLink v2 only
        "MAV_RADIO_TOUT": 5,
        "MAV_SIK_RADIO_ID": 0,
        "SER_TEL1_BAUD": 57600,
        "SER_TEL2_BAUD": 921600,
    })

    # ---- commander / failsafe ----------------------------------------------
    # COM_RCL_EXCEPT=4: ignore RC loss while OFFBOARD — the mission layer
    # also re-pushes this at runtime (reference basic_control.py:147-149).
    p.update({
        "COM_ARM_WO_GPS": 1,
        "COM_ARM_AUTH_REQ": 0,
        "COM_ARM_CHK_ESCS": 0,
        "COM_ARM_EKF_HGT": 1.0, "COM_ARM_EKF_POS": 0.5,
        "COM_ARM_EKF_VEL": 0.5, "COM_ARM_EKF_YAW": 0.5,
        "COM_ARM_IMU_ACC": 0.7, "COM_ARM_IMU_GYR": 0.25,
        "COM_ARM_MAG_ANG": 45, "COM_ARM_MAG_STR": 0,
        "COM_ARM_MIS_REQ": 0,
        "COM_ARM_SDCARD": 0,
        "COM_DISARM_LAND": 2.0,
        "COM_DISARM_PRFLT": 10.0,
        "COM_DL_LOSS_T": 10,
        "COM_EF_C2T": 5.0, "COM_EF_THROT": 0.5, "COM_EF_TIME": 10.0,
        "COM_FLIGHT_UUID": 0,
        "COM_FLTMODE1": -1, "COM_FLTMODE2": -1, "COM_FLTMODE3": -1,
        "COM_FLTMODE4": -1, "COM_FLTMODE5": -1, "COM_FLTMODE6": -1,
        "COM_HOME_H_T": 5.0, "COM_HOME_V_T": 10.0,
        "COM_KILL_DISARM": 5.0,
        "COM_LKDOWN_TKO": 3.0,
        "COM_LOW_BAT_ACT": 1,          # warn only: lab flights
        "COM_MOT_TEST_EN": 1,
        "COM_OBC_LOSS_T": 5.0,
        "COM_OBL_ACT": 0,              # offboard loss -> position hold
        "COM_OBL_RC_ACT": 0,
        "COM_OF_LOSS_T": 1.0,
        "COM_POSCTL_NAVL": 0,
        "COM_POS_FS_DELAY": 1,
        "COM_POS_FS_EPH": 5.0, "COM_POS_FS_EPV": 10.0,
        "COM_POWER_COUNT": 1,
        "COM_PREARM_MODE": 0,
        "COM_RCL_ACT_T": 15.0,
        "COM_RCL_EXCEPT": 4,
        "COM_RC_ARM_HYST": 1000,
        "COM_RC_IN_MODE": 0,
        "COM_RC_LOSS_T": 0.5,
        "COM_RC_OVERRIDE": 0,          # never let sticks yank OFFBOARD
        "COM_RC_STICK_OV": 30.0,
        "COM_REARM_GRACE": 1,
        "COM_SPOOLUP_TIME": 1.0,
        "COM_TAKEOFF_ACT": 0,
        "COM_VEL_FS_EVH": 1.0,
    })

    # ---- EKF2 (vision-aided indoor estimation) -----------------------------
    # The lab hexa flies on external vision (mocap → vision pose), so EKF2
    # fuses vision position+yaw and uses vision height.
    p.update({
        "EKF2_ABIAS_INIT": 0.2,
        "EKF2_ABL_LIM": 0.4,
        "EKF2_ACC_B_NOISE": 0.003,
        "EKF2_ACC_NOISE": 0.35,
        "EKF2_AID_MASK": 24,           # vision position + vision yaw
        "EKF2_ANGERR_INIT": 0.1,
        "EKF2_BARO_GATE": 5.0, "EKF2_BARO_NOISE": 3.5,
        "EKF2_BCOEF_X": 100.0, "EKF2_BCOEF_Y": 100.0,
        "EKF2_DECL_TYPE": 7,
        "EKF2_DRAG_NOISE": 2.5,
        "EKF2_EVA_NOISE": 0.1,
        "EKF2_EVP_GATE": 5.0, "EKF2_EVP_NOISE": 0.02,
        "EKF2_EVV_GATE": 3.0, "EKF2_EVV_NOISE": 0.1,
        "EKF2_EV_DELAY": 5.0,
        "EKF2_EV_NOISE_MD": 0,
        "EKF2_EV_POS_X": 0.0, "EKF2_EV_POS_Y": 0.0, "EKF2_EV_POS_Z": 0.0,
        "EKF2_FUSE_BETA": 0,
        "EKF2_GBIAS_INIT": 0.1,
        "EKF2_GND_EFF_DZ": 4.0, "EKF2_GND_MAX_HGT": 0.5,
        "EKF2_GPS_CHECK": 0,           # indoor: no GPS gating
        "EKF2_GPS_CTRL": 0,
        "EKF2_GYR_B_NOISE": 0.001,
        "EKF2_GYR_NOISE": 0.015,
        "EKF2_HEAD_NOISE": 0.3,
        "EKF2_HGT_MODE": 3,            # vision height
        "EKF2_IMU_POS_X": 0.0, "EKF2_IMU_POS_Y": 0.0, "EKF2_IMU_POS_Z": 0.0,
        "EKF2_MAG_ACCLIM": 0.5,
        "EKF2_MAG_B_NOISE": 0.0001,
        "EKF2_MAG_DECL": 0.0,
        "EKF2_MAG_E_NOISE": 0.001,
        "EKF2_MAG_GATE": 3.0,
        "EKF2_MAG_NOISE": 0.05,
        "EKF2_MAG_TYPE": 5,            # none: vision yaw replaces mag
        "EKF2_MAG_YAWLIM": 0.25,
        "EKF2_MIN_RNG": 0.1,
        "EKF2_NOAID_NOISE": 10.0,
        "EKF2_NOAID_TOUT": 5000000,
        "EKF2_PCOEF_XN": 0.0, "EKF2_PCOEF_XP": 0.0,
        "EKF2_PCOEF_YN": 0.0, "EKF2_PCOEF_YP": 0.0, "EKF2_PCOEF_Z": 0.0,
        "EKF2_PREDICT_US": 10000,
        "EKF2_REQ_EPH": 3.0, "EKF2_REQ_EPV": 5.0,
        "EKF2_REQ_GPS_H": 10.0,
        "EKF2_REQ_HDRIFT": 0.1, "EKF2_REQ_VDRIFT": 0.2,
        "EKF2_REQ_SACC": 0.5,
        "EKF2_RNG_A_HMAX": 5.0, "EKF2_RNG_A_VMAX": 1.0,
        "EKF2_RNG_DELAY": 5.0, "EKF2_RNG_GATE": 5.0,
        "EKF2_RNG_NOISE": 0.1,
        "EKF2_SEL_ERR_RED": 0.2,
        "EKF2_TAU_POS": 0.25, "EKF2_TAU_VEL": 0.25,
        "EKF2_TERR_GRAD": 0.5, "EKF2_TERR_NOISE": 5.0,
        "EKF2_WIND_NOISE": 0.1,
    })

    # ---- multicopter rate/attitude loops (tuned for the 2.2 kg hexa) ------
    p.update({
        "MC_ACRO_EXPO": 0.69, "MC_ACRO_EXPO_Y": 0.69,
        "MC_ACRO_P_MAX": 720.0, "MC_ACRO_R_MAX": 720.0, "MC_ACRO_Y_MAX": 540.0,
        "MC_ACRO_SUPEXPO": 0.7, "MC_ACRO_SUPEXPOY": 0.7,
        "MC_AIRMODE": 0,
        "MC_AT_EN": 0,
        "MC_BAT_SCALE_EN": 0,
        "MC_MAN_TILT_TAU": 0.0,
        "MC_PITCHRATE_D": 0.0016, "MC_PITCHRATE_FF": 0.0,
        "MC_PITCHRATE_I": 0.25, "MC_PITCHRATE_K": 1.0,
        "MC_PITCHRATE_MAX": 220.0, "MC_PITCHRATE_P": 0.14,
        "MC_PITCH_P": 6.8,
        "MC_PR_INT_LIM": 0.3,
        "MC_ROLLRATE_D": 0.0016, "MC_ROLLRATE_FF": 0.0,
        "MC_ROLLRATE_I": 0.25, "MC_ROLLRATE_K": 1.0,
        "MC_ROLLRATE_MAX": 220.0, "MC_ROLLRATE_P": 0.14,
        "MC_ROLL_P": 6.8,
        "MC_RR_INT_LIM": 0.3,
        "MC_YAWRATE_D": 0.0, "MC_YAWRATE_FF": 0.0,
        "MC_YAWRATE_I": 0.12, "MC_YAWRATE_K": 1.0,
        "MC_YAWRATE_MAX": 200.0, "MC_YAWRATE_P": 0.22,
        "MC_YAW_P": 3.2,
        "MC_YAW_WEIGHT": 0.4,
        "MC_YR_INT_LIM": 0.3,
    })

    # ---- multicopter position control (the PX4-side fallback the safety
    # box and MPC-OFF failsafe revert to — basic_control.py:448-451) -------
    p.update({
        "MPC_ACC_DOWN_MAX": 3.0, "MPC_ACC_HOR": 3.0, "MPC_ACC_HOR_MAX": 5.0,
        "MPC_ACC_UP_MAX": 4.0,
        "MPC_ALT_MODE": 0,
        "MPC_HOLD_DZ": 0.1, "MPC_HOLD_MAX_XY": 0.8, "MPC_HOLD_MAX_Z": 0.6,
        "MPC_JERK_AUTO": 4.0, "MPC_JERK_MAX": 8.0,
        "MPC_LAND_ALT1": 5.0, "MPC_LAND_ALT2": 2.0, "MPC_LAND_SPEED": 0.7,
        "MPC_MANTHR_MIN": 0.08,
        "MPC_MAN_TILT_MAX": 35.0, "MPC_MAN_Y_MAX": 150.0, "MPC_MAN_Y_TAU": 0.08,
        "MPC_POS_MODE": 4,
        "MPC_SPOOLUP_TIME": 1.0,
        "MPC_THR_CURVE": 0,
        "MPC_THR_HOVER": 0.42,        # hexa hover fraction (PX4 rate loop)
        "MPC_THR_MAX": 1.0, "MPC_THR_MIN": 0.12,
        "MPC_TILTMAX_AIR": 30.0, "MPC_TILTMAX_LND": 12.0,
        "MPC_TKO_RAMP_T": 1.0, "MPC_TKO_SPEED": 1.2,
        "MPC_USE_HTE": 1,
        "MPC_VELD_LP": 5.0,
        "MPC_VEL_MANUAL": 6.0,
        "MPC_XY_CRUISE": 4.0,
        "MPC_XY_ERR_MAX": 2.0,
        "MPC_XY_MAN_EXPO": 0.6,
        "MPC_XY_P": 0.95,
        "MPC_XY_TRAJ_P": 0.5,
        "MPC_XY_VEL_ALL": -10.0,
        "MPC_XY_VEL_D_ACC": 0.2, "MPC_XY_VEL_I_ACC": 0.4, "MPC_XY_VEL_P_ACC": 1.8,
        "MPC_XY_VEL_MAX": 6.0,
        "MPC_YAWRAUTO_MAX": 45.0,
        "MPC_YAW_EXPO": 0.6, "MPC_YAW_MODE": 0,
        "MPC_Z_MAN_EXPO": 0.6,
        "MPC_Z_P": 1.0,
        "MPC_Z_VEL_ALL": -3.0,
        "MPC_Z_VEL_D_ACC": 0.0, "MPC_Z_VEL_I_ACC": 2.0, "MPC_Z_VEL_P_ACC": 4.0,
        "MPC_Z_VEL_MAX_DN": 1.5, "MPC_Z_VEL_MAX_UP": 3.0,
        "MPC_Z_V_AUTO_DN": 1.5, "MPC_Z_V_AUTO_UP": 3.0,
    })

    # ---- mission / RTL / geofence ------------------------------------------
    p.update({
        "GF_ACTION": 1, "GF_ALTMODE": 0, "GF_COUNT": -1,
        "GF_MAX_HOR_DIST": 0.0, "GF_MAX_VER_DIST": 0.0, "GF_SOURCE": 0,
        "MIS_DIST_1WP": 900.0, "MIS_DIST_WPS": 900.0,
        "MIS_LTRMIN_ALT": -1.0, "MIS_MNT_YAW_CTL": 0,
        "MIS_TAKEOFF_ALT": 2.5, "MIS_TAKEOFF_REQ": 0, "MIS_YAW_ERR": 12.0,
        "MIS_YAW_TMT": -1.0,
        "NAV_ACC_RAD": 10.0, "NAV_DLL_ACT": 0, "NAV_FORCE_VT": 1,
        "NAV_FW_ALT_RAD": 10.0, "NAV_LOITER_RAD": 50.0,
        "NAV_MC_ALT_RAD": 0.8, "NAV_RCL_ACT": 0, "NAV_TRAFF_AVOID": 0,
        "RTL_CONE_ANG": 45, "RTL_DESCEND_ALT": 10.0, "RTL_HDG_MD": 0,
        "RTL_LAND_DELAY": 0.0, "RTL_LOITER_RAD": 50.0, "RTL_MIN_DIST": 5.0,
        "RTL_PLD_MD": 0, "RTL_RETURN_ALT": 10.0, "RTL_TYPE": 0,
    })

    # ---- battery (6S for the hexa) ------------------------------------------
    p.update({
        "BAT1_A_PER_V": 36.4, "BAT1_CAPACITY": 5200.0, "BAT1_I_CHANNEL": -1,
        "BAT1_N_CELLS": 6, "BAT1_R_INTERNAL": 0.005, "BAT1_SOURCE": 0,
        "BAT1_V_CHANNEL": -1, "BAT1_V_CHARGED": 4.05, "BAT1_V_DIV": 18.1,
        "BAT1_V_EMPTY": 3.6, "BAT1_V_LOAD_DROP": 0.3,
        "BAT_ADC_CHANNEL": -1, "BAT_AVRG_CURRENT": 15.0,
        "BAT_CRIT_THR": 0.07, "BAT_EMERGEN_THR": 0.05, "BAT_LOW_THR": 0.15,
        "BAT_N_CELLS": 6, "BAT_V_OFFS_CURR": 0.0,
    })

    # ---- actuators: 6 mains + PWM ranges ------------------------------------
    pwm = {
        "PWM_MAIN_MAX": 1950, "PWM_MAIN_MIN": 1100, "PWM_MAIN_RATE": 400,
        "PWM_MAIN_DISARM": 900,
        "PWM_AUX_MAX": 2000, "PWM_AUX_MIN": 1000, "PWM_AUX_RATE": 50,
        "PWM_AUX_DISARM": 1500,
        "PWM_SBUS_MODE": 0,
    }
    for ch in range(1, 9):
        up = 6 >= ch  # motors on mains 1..6, 7-8 unused
        pwm[f"PWM_MAIN_FAIL{ch}"] = -1
        pwm[f"PWM_MAIN_DIS{ch}"] = -1
        pwm[f"PWM_MAIN_MIN{ch}"] = -1 if up else 0
        pwm[f"PWM_MAIN_MAX{ch}"] = -1 if up else 0
        pwm[f"PWM_MAIN_TRIM{ch}"] = 0.0
        pwm[f"PWM_MAIN_REV{ch}"] = 0
    p.update(pwm)
    p.update({
        "THR_MDL_FAC": 0.3,            # thrust-PWM curve: matches the
                                       # framework's motor map (models/vehicles.py)
        "MOT_ORDERING": 0,
        "MOT_SLEW_MAX": 0.0,
    })

    # ---- RC: mapping + per-channel calibration ------------------------------
    rc = {
        "RC_CHAN_CNT": 8,
        "RC_MAP_ACRO_SW": 0, "RC_MAP_ARM_SW": 0, "RC_MAP_AUX1": 0,
        "RC_MAP_AUX2": 0, "RC_MAP_FAILSAFE": 0, "RC_MAP_FLAPS": 0,
        "RC_MAP_FLTMODE": 5, "RC_MAP_GEAR_SW": 0, "RC_MAP_KILL_SW": 7,
        "RC_MAP_LOITER_SW": 0, "RC_MAP_MAN_SW": 0, "RC_MAP_MODE_SW": 0,
        "RC_MAP_OFFB_SW": 6, "RC_MAP_PITCH": 2, "RC_MAP_POSCTL_SW": 0,
        "RC_MAP_RATT_SW": 0, "RC_MAP_RETURN_SW": 0, "RC_MAP_ROLL": 1,
        "RC_MAP_STAB_SW": 0, "RC_MAP_THROTTLE": 3, "RC_MAP_TRANS_SW": 0,
        "RC_MAP_YAW": 4,
        "RC_FAILS_THR": 0, "RC_RSSI_PWM_CHAN": 0, "RC_RSSI_PWM_MAX": 1000,
        "RC_RSSI_PWM_MIN": 2000,
    }
    # sim radio: ideal symmetric calibration on all 18 channels the
    # firmware exposes (RC_CHAN_CNT stays 8 — that is the radio's fact;
    # the param SURFACE always carries all 18, like any real dump)
    for ch in range(1, 19):
        rc[f"RC{ch}_DZ"] = 10.0
        rc[f"RC{ch}_MAX"] = 2000.0
        rc[f"RC{ch}_MIN"] = 1000.0
        rc[f"RC{ch}_REV"] = 1.0
        rc[f"RC{ch}_TRIM"] = 1500.0
    p.update(rc)

    # ---- sensors / calibration (sim: identity rotations, zero offsets) -----
    cal = {
        "CAL_ACC0_ID": 1310988, "CAL_ACC0_PRIO": 50, "CAL_ACC0_ROT": 0,
        "CAL_ACC1_ID": 0, "CAL_ACC1_PRIO": -1,
        "CAL_BARO0_ID": 6620172, "CAL_BARO0_PRIO": 50,
        "CAL_GYRO0_ID": 1310988, "CAL_GYRO0_PRIO": 50, "CAL_GYRO0_ROT": 0,
        "CAL_GYRO1_ID": 0, "CAL_GYRO1_PRIO": -1,
        "CAL_MAG0_ID": 197388, "CAL_MAG0_PRIO": 50, "CAL_MAG0_ROT": 0,
        "CAL_MAG1_ID": 0, "CAL_MAG1_PRIO": -1,
    }
    for axis in "XYZ":
        cal[f"CAL_ACC0_{axis}OFF"] = 0.0
        cal[f"CAL_ACC0_{axis}SCALE"] = 1.0
        cal[f"CAL_GYRO0_{axis}OFF"] = 0.0
        cal[f"CAL_MAG0_{axis}OFF"] = 0.0
        cal[f"CAL_MAG0_{axis}SCALE"] = 1.0
    # the firmware always dumps FOUR instance slots per sensor type; the
    # sim vehicle populates slot 0, slots 1-3 stay at the uninitialized
    # defaults (ID 0, PRIO -1, identity cal) like any single-IMU vehicle
    for inst in (1, 2, 3):
        for sens in ("ACC", "GYRO", "MAG"):
            cal[f"CAL_{sens}{inst}_ID"] = 0
            cal[f"CAL_{sens}{inst}_PRIO"] = -1
            cal[f"CAL_{sens}{inst}_ROT"] = -1
            for axis in "XYZ":
                cal[f"CAL_{sens}{inst}_{axis}OFF"] = 0.0
                if sens != "GYRO":
                    cal[f"CAL_{sens}{inst}_{axis}SCALE"] = 1.0
        cal[f"CAL_BARO{inst}_ID"] = 0
        cal[f"CAL_BARO{inst}_PRIO"] = -1
    cal["CAL_ACC1_ROT"] = -1
    cal["CAL_GYRO1_ROT"] = -1
    cal["CAL_MAG1_ROT"] = -1
    # soft-iron cross-terms / motor-current compensation: identity/off
    for axis in "XYZ":
        cal[f"CAL_MAG0_{axis}ODIAG"] = 0.0
        cal[f"CAL_MAG0_{axis}COMP"] = 0.0
    cal.update({
        "CAL_MAG_COMP_TYP": 0, "CAL_MAG_ROT_AUTO": 1, "CAL_MAG_SIDES": 63,
        "CAL_AIR_CMODEL": 0, "CAL_AIR_TUBED_MM": 1.5,
        "CAL_AIR_TUBELEN": 0.2,
    })
    p.update(cal)
    p.update({
        "IMU_ACCEL_CUTOFF": 30.0,
        "IMU_DGYRO_CUTOFF": 30.0,
        "IMU_GYRO_CAL_EN": 1,
        "IMU_GYRO_CUTOFF": 40.0,
        "IMU_GYRO_DNF_EN": 0,
        "IMU_GYRO_NF0_BW": 20.0, "IMU_GYRO_NF0_FRQ": 0.0,
        "IMU_GYRO_RATEMAX": 400,
        "IMU_INTEG_RATE": 200,
        "SENS_BARO_QNH": 1013.25,
        "SENS_BOARD_ROT": 0,
        "SENS_BOARD_X_OFF": 0.0, "SENS_BOARD_Y_OFF": 0.0, "SENS_BOARD_Z_OFF": 0.0,
        "SENS_EN_THERMAL": -1,
        "SENS_EXT_I2C_PRB": 1,
        "SENS_FLOW_MAXHGT": 3.0, "SENS_FLOW_MAXR": 2.5,
        "SENS_FLOW_MINHGT": 0.08, "SENS_FLOW_ROT": 0,
        "SENS_IMU_MODE": 1,
        "SENS_IMU_TEMP": 55.0,
        "SENS_TEMP_ID": 1310988,
    })

    # ---- land detector (2.2 kg hexa) ----------------------------------------
    p.update({
        "LNDMC_ALT_MAX": -1.0,
        "LNDMC_ROT_MAX": 20.0,
        "LNDMC_TRIG_TIME": 1.0,
        "LNDMC_XY_VEL_MAX": 1.5,
        "LNDMC_Z_VEL_MAX": 0.5,
        "LND_FLIGHT_T_HI": 0, "LND_FLIGHT_T_LO": 0,
    })

    # ---- logging -------------------------------------------------------------
    p.update({
        "SDLOG_ALGORITHM": 2,
        "SDLOG_BOOT_BAT": 0,
        "SDLOG_DIRS_MAX": 0,
        "SDLOG_MISSION": 0,
        "SDLOG_MODE": 0,
        "SDLOG_PROFILE": 19,           # default + high-rate + debug: the
                                       # analysis layouts need rate/actuator
                                       # topics at full rate (tools/analyze.py)
        "SDLOG_UTC_OFFSET": 0,
        "SDLOG_UUID": 1,
    })

    # ---- circuit breakers (sim/lab: relax supply+IO checks) ----------------
    p.update({
        "CBRK_AIRSPD_CHK": 0,
        "CBRK_BUZZER": 0,
        "CBRK_ENGINEFAIL": 284953,
        "CBRK_FLIGHTTERM": 121212,
        "CBRK_IO_SAFETY": 22027,
        "CBRK_SUPPLY_CHK": 894281,
        "CBRK_USB_CHK": 197848,
        "CBRK_VELPOSERR": 0,
        "CBRK_VTOLARMING": 0,
    })

    # ---- control allocation (hexa X geometry) ------------------------------
    # The real-vehicle dump's largest missing family (121 CA_* lines in
    # launch/params_hexa_ahg.params). Rotor positions follow the PX4 hexa X
    # layout (30°-offset arms, alternating spin), arm length 0.275 m — the
    # same geometry models/vehicles.py::hexa_config mixes with, so the
    # allocator and the learned model agree on motor ordering.
    import math

    ca: dict = {
        "CA_AIRFRAME": 0,              # multirotor
        "CA_METHOD": 1,                # sequential desaturation
        "CA_R_REV": 0,
        "CA_ROTOR_COUNT": 6,
        "CA_SV_CS_COUNT": 0,
    }
    # PX4 hexa X rotor angles (deg, body FRD, motor index = PX4 order) and
    # spin directions; CT/KM are the v1.13 defaults.
    hexa_x = [(90, -1), (270, 1), (30, 1), (210, -1), (150, -1), (330, 1)]
    for i, (ang_deg, spin) in enumerate(hexa_x):
        a = math.radians(ang_deg)
        ca[f"CA_ROTOR{i}_PX"] = round(0.275 * math.cos(a), 4)
        ca[f"CA_ROTOR{i}_PY"] = round(0.275 * math.sin(a), 4)
        ca[f"CA_ROTOR{i}_PZ"] = 0.0
        ca[f"CA_ROTOR{i}_AX"] = 0.0
        ca[f"CA_ROTOR{i}_AY"] = 0.0
        ca[f"CA_ROTOR{i}_AZ"] = -1.0
        ca[f"CA_ROTOR{i}_CT"] = 6.5
        ca[f"CA_ROTOR{i}_KM"] = round(0.05 * spin, 4)
        ca[f"CA_ROTOR{i}_TILT"] = 0
    for i in range(6):                 # actuator output ranges (motors)
        ca[f"CA_ACT{i}_MIN"] = 0.0
        ca[f"CA_ACT{i}_MAX"] = 1.0
    p.update(ca)

    # ---- failure detector ---------------------------------------------------
    p.update({
        "FD_ACT_EN": 1,
        "FD_ACT_MOT_C2T": 2.0, "FD_ACT_MOT_THR": 0.2,
        "FD_ACT_MOT_TOUT": 100,
        "FD_ESCS_EN": 0,               # PWM ESCs: no telemetry to check
        "FD_EXT_ATS_EN": 0, "FD_EXT_ATS_TRIG": 1900,
        "FD_FAIL_P": 60, "FD_FAIL_P_TTRI": 0.3,
        "FD_FAIL_R": 60, "FD_FAIL_R_TTRI": 0.3,
    })

    # ---- hover thrust estimator --------------------------------------------
    # Feeds the land detector + velocity controller feedforward; the MPC's
    # own hover point is cost_params.uref (configs/hexa_*.yaml).
    p.update({
        "HTE_ACC_GATE": 3.0,
        "HTE_HT_ERR_INIT": 0.1,
        "HTE_HT_NOISE": 0.0036,
        "HTE_THR_RANGE": 0.2,
        "HTE_VXY_THRESH": 10.0,
    })

    # ---- second battery slot (present-but-unconfigured, as on v1.13) -------
    p.update({
        "BAT2_A_PER_V": 36.36, "BAT2_CAPACITY": -1.0,
        "BAT2_I_CHANNEL": -1, "BAT2_N_CELLS": 0,
        "BAT2_R_INTERNAL": -1.0, "BAT2_SOURCE": -1,
        "BAT2_V_CHANNEL": -1, "BAT2_V_DIV": 18.18,
        "BAT2_V_EMPTY": 3.5, "BAT2_V_CHARGED": 4.05, "BAT2_V_LOAD_DROP": 0.3,
    })

    # ---- UAVCAN (disabled: this vehicle drives PWM ESCs) --------------------
    # The real hexa's dump carries the full 95-line UAVCAN surface because
    # its firmware includes the UAVCAN module; the values below are the v1.13
    # defaults with the node disabled — documenting the same surface
    # without pretending this vehicle has CAN ESCs.
    uav: dict = {
        "UAVCAN_ENABLE": 0,
        "UAVCAN_NODE_ID": 1,
        "UAVCAN_BITRATE": 1000000,
        "UAVCAN_BAT_MON": 0,
        "UAVCAN_ECESC_EN": 0,
        "UAVCAN_ESC_IDLT": 1,
        "UAVCAN_LGT_ANTCL": 2, "UAVCAN_LGT_LAND": 0,
        "UAVCAN_LGT_NAV": 3, "UAVCAN_LGT_STROB": 1,
        "UAVCAN_PUB_ARM": 0, "UAVCAN_PUB_RTCM": 0,
        "UAVCAN_RNG_MAX": 200.0, "UAVCAN_RNG_MIN": 0.3,
        "UAVCAN_SUB_ASPD": 0, "UAVCAN_SUB_BARO": 0, "UAVCAN_SUB_BAT": 0,
        "UAVCAN_SUB_BTN": 0, "UAVCAN_SUB_DPRES": 0, "UAVCAN_SUB_FLOW": 0,
        "UAVCAN_SUB_GPS": 1, "UAVCAN_SUB_HYGRO": 0, "UAVCAN_SUB_ICE": 0,
        "UAVCAN_SUB_IMU": 0, "UAVCAN_SUB_MAG": 1, "UAVCAN_SUB_RNG": 0,
    }
    p.update(uav)

    # ---- precision landing / follow-me (defaults, modules present) ---------
    p.update({
        "PLD_BTOUT": 5.0, "PLD_FAPPR_ALT": 0.1, "PLD_HACC_RAD": 0.2,
        "PLD_MAX_SRCH": 3, "PLD_SRCH_ALT": 10.0, "PLD_SRCH_TOUT": 10.0,
        "FLW_TGT_ALT_M": 8.0, "FLW_TGT_DST": 8.0, "FLW_TGT_FA": 180.0,
        "FLW_TGT_HT": 3, "FLW_TGT_MAX_VEL": 5.0, "FLW_TGT_RS": 0.1,
    })

    # ---- misc modules rounding out the v1.13 surface ------------------------
    p.update({
        "LNDFW_AIRSPD_MAX": 6.0, "LNDFW_VEL_XY_MAX": 5.0,
        "LNDFW_VEL_Z_MAX": 3.0, "LNDFW_XYACC_MAX": 8.0,
        "LND_FLIGHT_T_HI2": 0,
        "MNT_MODE_IN": -1, "MNT_MODE_OUT": 0,
        "TRIG_INTERFACE": 4, "TRIG_MODE": 0,
        "EV_TSK_RC_LOSS": 0, "EV_TSK_STAT_DIS": 0,
        "GPS_1_CONFIG": 201, "GPS_1_GNSS": 0, "GPS_1_PROTOCOL": 1,
        "GPS_2_CONFIG": 0,
        "GPS_DUMP_COMM": 0, "GPS_UBX_DYNMODEL": 7, "GPS_UBX_MODE": 0,
        "GPS_YAW_OFFSET": 0.0,
        "IMU_GYRO_FFT_EN": 0,
        "MOT_ORDERING": 0,
        "MPC_YAWRAUTO_MAX": 45.0,
        "PWM_MAIN_RATE": 400, "PWM_MAIN_REV": 0,
        "PWM_AUX_RATE": 50, "PWM_AUX_REV": 0,
        # (RC_MAP_* switch assignments live in the RC section above — do
        # not repeat them here: a later dict.update silently wins, which
        # once zeroed the deliberate RC_MAP_OFFB_SW=6 mapping)
        "RC_MAP_AUX3": 0, "RC_MAP_PARAM1": 0,
        "RC_MAP_PARAM2": 0, "RC_MAP_PARAM3": 0,
        "RTL_CONE_ANG": 45, "RTL_HDG_MD": 0, "RTL_LOITER_RAD": 50.0,
        "RTL_PLD_MD": 0, "RTL_TIME_FACTOR": 1.1, "RTL_TIME_MARGIN": 100,
    })

    # ---- module-coverage extension (round 4) -------------------------------
    # The reference's real-vehicle dump is 1,073 lines because a full
    # firmware exposes EVERY built module's params, not just the ones the
    # vehicle uses. The blocks below round the generated surface out to
    # that footprint: values are the stock v1.13-era defaults for modules
    # this simulated vehicle never touches (allocation slots beyond the 6
    # motors, CAN ESC mappings, disabled optional sensor modules). None of them
    # affect the MPC-offboard contract — the overrides that do are in the
    # sections above and in configs/params_hexa.params.

    # control-allocation: the effectiveness surface always carries 12
    # rotor slots + 8 servo slots; 6..11 are the unused defaults
    ca_ext: dict = {"CA_FAILURE_MODE": 0}
    for r in range(6, 12):
        ca_ext[f"CA_ROTOR{r}_AX"] = 0.0
        ca_ext[f"CA_ROTOR{r}_AY"] = 0.0
        ca_ext[f"CA_ROTOR{r}_AZ"] = -1.0
        ca_ext[f"CA_ROTOR{r}_CT"] = 6.5
        ca_ext[f"CA_ROTOR{r}_KM"] = 0.05
        ca_ext[f"CA_ROTOR{r}_PX"] = 0.0
        ca_ext[f"CA_ROTOR{r}_PY"] = 0.0
        ca_ext[f"CA_ROTOR{r}_PZ"] = 0.0
    for r in range(0, 12):
        ca_ext[f"CA_R{r}_SLEW"] = 0.0
    for s in range(0, 8):
        ca_ext[f"CA_SV{s}_SLEW"] = 0.0
    p.update(ca_ext)

    # per-channel AUX outputs (unused: defaults) + output functions
    pwm_ext: dict = {}
    for ch in range(1, 7):
        pwm_ext[f"PWM_AUX_DIS{ch}"] = -1
        pwm_ext[f"PWM_AUX_FAIL{ch}"] = -1
        pwm_ext[f"PWM_AUX_MIN{ch}"] = -1
        pwm_ext[f"PWM_AUX_MAX{ch}"] = -1
        pwm_ext[f"PWM_AUX_FUNC{ch}"] = 0
    for ch in range(1, 9):
        pwm_ext[f"PWM_MAIN_FUNC{ch}"] = 0
    p.update(pwm_ext)

    # UAVCAN ESC/servo output mapping (node disabled above; the mapping
    # surface ships regardless)
    uav_ext: dict = {"UAVCAN_EC_REV": 0, "UAVCAN_SV_REV": 0,
                     "UAVCAN_PUB_MBD": 0}
    for ch in range(1, 9):
        uav_ext[f"UAVCAN_EC_FUNC{ch}"] = 0
        uav_ext[f"UAVCAN_EC_FAIL{ch}"] = -1
        uav_ext[f"UAVCAN_EC_MIN{ch}"] = 1
        uav_ext[f"UAVCAN_EC_MAX{ch}"] = 8191
        uav_ext[f"UAVCAN_SV_FUNC{ch}"] = 0
        uav_ext[f"UAVCAN_SV_FAIL{ch}"] = -1
        uav_ext[f"UAVCAN_SV_DIS{ch}"] = -1
        uav_ext[f"UAVCAN_SV_MIN{ch}"] = 1000
        uav_ext[f"UAVCAN_SV_MAX{ch}"] = 2000
    p.update(uav_ext)

    # EKF2: the estimator's full tuning surface at stock defaults (the
    # fusion sources this vehicle DOES use are configured in the EKF2
    # section above)
    p.update({
        "EKF2_ABL_ACCLIM": 25.0, "EKF2_ABL_GYRLIM": 3.0, "EKF2_ABL_TAU": 0.5,
        "EKF2_ASPD_MAX": 20.0, "EKF2_ASP_DELAY": 100.0,
        "EKF2_AVEL_DELAY": 5.0,
        "EKF2_BARO_CTRL": 1, "EKF2_BARO_DELAY": 0.0,
        "EKF2_BETA_GATE": 5.0, "EKF2_BETA_NOISE": 0.3,
        "EKF2_EAS_NOISE": 1.4,
        "EKF2_GPS_DELAY": 110.0,
        "EKF2_GPS_POS_X": 0.0, "EKF2_GPS_POS_Y": 0.0, "EKF2_GPS_POS_Z": 0.0,
        "EKF2_GPS_P_GATE": 5.0, "EKF2_GPS_P_NOISE": 0.5,
        "EKF2_GPS_V_GATE": 5.0, "EKF2_GPS_V_NOISE": 0.3,
        "EKF2_GSF_TAS": 15.0,
        "EKF2_HDG_GATE": 2.6,
        "EKF2_MAG_CHECK": 0, "EKF2_MAG_DELAY": 0.0,
        "EKF2_MCOEF": 0.0,
        "EKF2_MULTI_IMU": 0, "EKF2_MULTI_MAG": 0,
        "EKF2_OF_DELAY": 20.0, "EKF2_OF_GATE": 3.0,
        "EKF2_OF_N_MAX": 0.5, "EKF2_OF_N_MIN": 0.15,
        "EKF2_OF_POS_X": 0.0, "EKF2_OF_POS_Y": 0.0, "EKF2_OF_POS_Z": 0.0,
        "EKF2_OF_QMIN": 1,
        "EKF2_REQ_NSATS": 6, "EKF2_REQ_PDOP": 2.5,
        "EKF2_RNG_A_IGATE": 1.0, "EKF2_RNG_K_GATE": 5.0,
        "EKF2_RNG_PITCH": 0.0,
        "EKF2_RNG_POS_X": 0.0, "EKF2_RNG_POS_Y": 0.0, "EKF2_RNG_POS_Z": 0.0,
        "EKF2_RNG_QLTY_T": 1.0, "EKF2_RNG_SFE": 0.05,
        "EKF2_SYNT_MAG_Z": 0,
        "EKF2_TAS_GATE": 3.0, "EKF2_TERR_MASK": 3,
    })

    # optional sensor modules: every port-config/enable at "disabled"
    p.update({
        "SENS_BARO_RATE": 20.0, "SENS_CM8JL65_CFG": 0,
        "SENS_DPRES_ANSC": 0.0, "SENS_DPRES_OFF": 0.0,
        "SENS_EN_ADIS164X": 0, "SENS_EN_BATT": 0, "SENS_EN_IRLOCK": 0,
        "SENS_EN_LL40LS": 0, "SENS_EN_MB12XX": 0, "SENS_EN_MPDT": 0,
        "SENS_EN_MS4525DO": 0, "SENS_EN_MS5525DS": 0, "SENS_EN_PAA3905": 0,
        "SENS_EN_PAW3902": 0, "SENS_EN_PGA460": 0, "SENS_EN_PMW3901": 0,
        "SENS_EN_PX4FLOW": 0, "SENS_EN_SDP3X": 0, "SENS_EN_SF1XX": 0,
        "SENS_EN_TRANGER": 0, "SENS_EN_VL53L1X": 0,
        "SENS_GPS_MASK": 0, "SENS_GPS_PRIME": 0, "SENS_GPS_TAU": 10.0,
        "SENS_LEDDAR1_CFG": 0, "SENS_MAG_AUTOCAL": 1, "SENS_MAG_MODE": 1,
        "SENS_MAG_RATE": 15.0, "SENS_SF0X_CFG": 0, "SENS_TFLOW_CFG": 0,
        "SENS_TFMINI_CFG": 0, "SENS_ULAND_CFG": 0,
    })

    # commander / failsafe knobs not exercised by the MPC-offboard flow
    p.update({
        "COM_ACT_FAIL_ACT": 0, "COM_ARM_AUTH_ID": 10, "COM_ARM_AUTH_MET": 0,
        "COM_ARM_AUTH_TO": 1.0, "COM_ARM_SWISBTN": 0, "COM_CPU_MAX": 90.0,
        "COM_FAIL_ACT_T": 5.0, "COM_FLT_PROFILE": 0, "COM_FLT_TIME_MAX": -1,
        "COM_FORCE_SAFETY": 0, "COM_HLDL_LOSS_T": 120, "COM_HLDL_REG_T": 0,
        "COM_HOME_EN": 1, "COM_HOME_IN_AIR": 0, "COM_IMB_PROP_ACT": 0,
        "COM_OBS_AVOID": 0, "COM_PARACHUTE": 0, "COM_QC_ACT": 0,
        "COM_WIND_MAX": -1.0, "COM_WIND_WARN": -1.0,
    })

    # gyro notch/FFT surface (dynamic notch disabled above)
    p.update({
        "IMU_GYRO_DNF_BW": 15.0, "IMU_GYRO_DNF_HMC": 3,
        "IMU_GYRO_FFT_LEN": 512, "IMU_GYRO_FFT_MAX": 192.0,
        "IMU_GYRO_FFT_MIN": 32.0, "IMU_GYRO_FFT_SNR": 10.0,
        "IMU_GYRO_NF1_BW": 20.0, "IMU_GYRO_NF1_FRQ": 0.0,
    })

    # mavlink instance extras, autotune, misc modules
    p.update({
        "MAV_0_FLOW_CTRL": 2, "MAV_1_FLOW_CTRL": 2, "MAV_FWDEXTSP": 1,
        "MAV_HASH_CHK_EN": 1, "MAV_ODOM_LP": 0, "MAV_USEHILGPS": 0,
        "MC_AT_APPLY": 1, "MC_AT_RISE_TIME": 0.14, "MC_AT_START": 0,
        "MC_AT_SYSID_AMP": 0.7, "MC_ORBIT_RAD_MAX": 1000.0,
        "NAV_FW_ALTL_RAD": 90.0, "NAV_TRAFF_A_RADM": 500.0,
        "NAV_TRAFF_A_RADU": 10.0,
        "TC_A_ENABLE": 0, "TC_B_ENABLE": 0, "TC_G_ENABLE": 0,
        "TEL_BST_EN": 0, "TEL_FRSKY_CONFIG": 0, "TEL_HOTT_CONFIG": 0,
        "WV_EN": 0, "WV_GAIN": 1.0, "WV_ROLL_MIN": 1.0,
        "WV_YRATE_MAX": 90.0,
        "CP_DELAY": 0.4, "CP_DIST": -1.0, "CP_GO_NO_DATA": 0,
        "CP_GUIDE_ANG": 30.0,
        "DSHOT_3D_DEAD_H": 1000, "DSHOT_3D_DEAD_L": 1000,
        "DSHOT_3D_ENABLE": 0, "DSHOT_MIN": 0.055, "DSHOT_TEL_CFG": 0,
        "FW_AIRSPD_TRIM": 15.0, "FW_ARSP_MODE": 0, "FW_PSP_OFF": 0.0,
        "FW_T_CLMB_R_SP": 3.0, "FW_T_SINK_R_SP": 2.0,
    })

    # last-mile surface: RC switch thresholds, manual-flight speed knobs,
    # legacy battery aliases, misc module enables. (A handful of params in
    # a real 1.13-dev dump are LEFT OUT deliberately — e.g. EKF2_HGT_REF
    # (would shadow the EKF2_HGT_MODE=3 vision-height override above),
    # EKF2_SEL_IMU_*, PWM_*_TIM* — where a wrong "default" would be worse
    # than a documented absence.)
    p.update({
        "RC_ARMSWITCH_TH": 0.75, "RC_ENG_MOT_TH": 0.75, "RC_GEAR_TH": 0.75,
        "RC_KILLSWITCH_TH": 0.75, "RC_LOITER_TH": 0.75, "RC_OFFB_TH": 0.75,
        "RC_RETURN_TH": 0.75, "RC_TRANS_TH": 0.75,
        "RC_MAP_AUX4": 0, "RC_MAP_AUX5": 0, "RC_MAP_AUX6": 0,
        "RC_MAP_ENG_MOT": 0, "RC_MAP_FLTM_BTN": 0,
        "MPC_LAND_ALT3": -1.0, "MPC_LAND_CRWL": -1.0,
        "MPC_LAND_RC_HELP": 0, "MPC_THR_XY_MARG": 0.3,
        "MPC_VEL_MAN_BACK": -1.0, "MPC_VEL_MAN_SIDE": -1.0,
        "SYS_DM_BACKEND": 0, "SYS_FAC_CAL_MODE": 0, "SYS_HAS_GPS": 1,
        "SYS_HAS_NUM_DIST": 0, "SYS_RGB_MAXBRT": 1.0,
        "SYS_VEHICLE_RESP": -0.4,
        "MAN_ARM_GESTURE": 1, "MBE_ENABLE": 1, "MBE_LEARN_GAIN": 18.0,
        "MIS_PD_TO": -1.0, "MOT_POLE_COUNT": 14,
        "HTE_VXY_THR": 1.0, "HTE_VZ_THR": 2.0,
        "GF_PREDICT": 1, "FD_IMB_PROP_THR": 30,
        "CAM_CAP_FBACK": 0, "BATMON_DRIVER_EN": 0,
        "ASPD_SCALE_1": 1.0, "COM_ARM_ARSP_EN": 1,
        "GND_SPEED_THR_SC": 1.0, "MXS_SER_CFG": 0,
        "SENS_IMU_AUTOCAL": 1, "EKF2_RNG_CTRL": 1, "EKF2_ARSP_THR": 0.0,
        "BAT_V_CHARGED": 4.05, "BAT_V_EMPTY": 3.5, "BAT_V_LOAD_DROP": 0.3,
        "VTO_LOITER_ALT": 80.0, "VT_B_DEC_MSS": 2.0, "VT_B_REV_DEL": 0.0,
    })

    return p


def main(out_path: Optional[str] = None) -> str:
    """Write the dump to ``out_path`` (default ``build/params_hexa_full.params``);
    returns the path."""
    out = out_path or os.path.join(_ROOT, "build", "params_hexa_full.params")
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    params = build_params()
    dump_params_file(out, params, header=HEADER)
    print(f"wrote {len(params)} params -> {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
